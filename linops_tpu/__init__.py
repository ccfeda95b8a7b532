"""linops_tpu — a matrix-free linear-operator framework in JAX.

A JAX/XLA design with the capabilities of LinearOperators.jl (see
SURVEY.md): lazy operator algebra as an explicit pytree operator graph,
every apply jit-compiled into one fused computation, quasi-Newton
operators with device-resident ring buffers, sparse CSR/COO/BSR/ELL/DIA
operators, and mesh-sharded partitioned operators for multi-device
scaling.
"""

from .core.base import (
    LinearOperator as AbstractLinearOperator,
    LinearOperatorException,
    Counters,
)
from .core.dense import MatrixOperator, FunctionOperator, make_operator, aslinearoperator

# Reference-parity spelling: `LinearOperator(...)` is the polymorphic factory
# (the abstract base is exported as AbstractLinearOperator, as in the
# reference).
LinearOperator = make_operator

from .core.algebra import Scale, Sum, Compose
from .core.adjoint import (
    AdjointOperator,
    TransposeOperator,
    ConjugateOperator,
    adjoint,
    transpose,
    conj,
)
from .core.apply import matvec, matmat, mul, to_dense, apply_cache_sizes
from .core.ad import apply_linear

from .ops.eye import Eye, UniversalEye, Ones, Zeros, opEye, opOnes, opZeros
from .ops.diagonal import DiagonalOperator, opDiagonal
from .ops.restriction import RestrictionOperator, opRestriction, opExtension
from .ops.permutation import PermutationOperator, opPermutation
from .ops.cat import (
    HCatOperator,
    VCatOperator,
    BlockDiagonalOperator,
    hcat,
    vcat,
    hvcat,
)
from .ops.kron import KronOperator, kron
from .ops.shifted import ShiftedOperator
from .ops.linalg_ops import (
    InverseOperator,
    IterativeInverseOperator,
    CholeskyOperator,
    LDLOperator,
    HouseholderOperator,
    HermitianOperator,
    opInverse,
    opIterativeInverse,
    opCholesky,
    opLDL,
    opHouseholder,
    opHermitian,
)
from .ops.timed import TimedOperator
from .ops.sparse_factor import SparseInverseOperator, opSparseInverse, opSparseLDL

from .qn import (
    LBFGSState,
    LBFGSOperator,
    InverseLBFGSOperator,
    LSR1State,
    LSR1Operator,
    DiagonalQNOperator,
    DiagonalPSB,
    DiagonalAndrei,
    SpectralGradient,
    DiagonalBFGS,
    solve_shifted_system,
    solve_shifted_systems,
    ldiv,
)

from .sparse import (
    COO,
    CSR,
    BSR,
    ELL,
    COOOperator,
    CSROperator,
    RoutedCSROperator,
    BSROperator,
    ELLOperator,
    opSparse,
    ReorderedOperator,
    DIAOperator,
    opDIA,
    dia_from_dense,
    laplacian_1d,
    laplacian_2d,
    laplacian_2d_dia,
    StencilOperator,
    Stencil2DOperator,
    opStencil2D,
    opStencil,
)

from .utils.norm import normest, estimate_opnorm
from .utils.estimate import (estimate_trace, estimate_diagonal,
                             estimate_spectral_sum, estimate_logdet,
                             funm_apply)
from .utils.eig import (lobpcg, svds, rsvd, nystrom_preconditioner,
                        NystromPreconditioner)
from .utils.krylov import (matvec_chain, cg, gmres, minres, bicgstab, lsqr,
                           chebyshev, power_iteration)
from .utils.checkpoint import save_operator, load_operator_state, op_state
from .utils.checks import check_ctranspose, check_hermitian, check_positive_definite

__version__ = "0.1.0"

__all__ = [
    "AbstractLinearOperator",
    "LinearOperator",
    "LinearOperatorException",
    "Counters",
    "MatrixOperator",
    "FunctionOperator",
    "make_operator",
    "aslinearoperator",
    "Scale",
    "Sum",
    "Compose",
    "AdjointOperator",
    "TransposeOperator",
    "ConjugateOperator",
    "adjoint",
    "transpose",
    "conj",
    "matvec",
    "matmat",
    "mul",
    "to_dense",
    "apply_cache_sizes",
    "apply_linear",
    "Eye",
    "UniversalEye",
    "Ones",
    "Zeros",
    "opEye",
    "opOnes",
    "opZeros",
    "DiagonalOperator",
    "opDiagonal",
    "RestrictionOperator",
    "opRestriction",
    "opPermutation",
    "PermutationOperator",
    "opExtension",
    "HCatOperator",
    "VCatOperator",
    "BlockDiagonalOperator",
    "hcat",
    "vcat",
    "hvcat",
    "KronOperator",
    "kron",
    "ShiftedOperator",
    "InverseOperator",
    "CholeskyOperator",
    "LDLOperator",
    "HouseholderOperator",
    "HermitianOperator",
    "opInverse",
    "opIterativeInverse",
    "IterativeInverseOperator",
    "opCholesky",
    "opLDL",
    "opHouseholder",
    "opHermitian",
    "TimedOperator",
    "TimedLinearOperator",
    "AdjointLinearOperator",
    "TransposeLinearOperator",
    "ConjugateLinearOperator",
    "SparseInverseOperator",
    "opSparseInverse",
    "opSparseLDL",
    "LBFGSState",
    "LBFGSOperator",
    "InverseLBFGSOperator",
    "LSR1State",
    "LSR1Operator",
    "DiagonalQNOperator",
    "DiagonalPSB",
    "DiagonalAndrei",
    "SpectralGradient",
    "DiagonalBFGS",
    "solve_shifted_system",
    "solve_shifted_systems",
    "ldiv",
    "COO",
    "CSR",
    "BSR",
    "ELL",
    "COOOperator",
    "CSROperator",
    "RoutedCSROperator",
    "BSROperator",
    "ELLOperator",
    "opSparse",
    "ReorderedOperator",
    "DIAOperator",
    "opDIA",
    "dia_from_dense",
    "laplacian_1d",
    "laplacian_2d",
    "laplacian_2d_dia",
    "StencilOperator",
    "Stencil2DOperator",
    "opStencil",
    "opStencil2D",
    "normest",
    "matvec_chain",
    "cg",
    "gmres",
    "minres",
    "bicgstab",
    "lsqr",
    "chebyshev",
    "power_iteration",
    "save_operator",
    "load_operator_state",
    "op_state",
    "estimate_opnorm",
    "estimate_trace",
    "estimate_diagonal",
    "estimate_spectral_sum",
    "estimate_logdet",
    "funm_apply",
    "lobpcg",
    "svds",
    "rsvd",
    "nystrom_preconditioner",
    "NystromPreconditioner",
    "check_ctranspose",
    "check_hermitian",
    "check_positive_definite",
]


# Reference-name aliases (LinearOperators.jl export names) so migrating
# users find the exact identifiers they know; the names above are the
# primary API (reference: src/LinearOperators.jl exports).
TimedLinearOperator = TimedOperator
AdjointLinearOperator = AdjointOperator
TransposeLinearOperator = TransposeOperator
ConjugateLinearOperator = ConjugateOperator
