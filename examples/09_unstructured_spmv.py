"""Unstructured sparse operators: CSR, routed SpMV, permutations, RCM.

The reference delegates unstructured SpMV to SparseArrays CSC mul! on the
host (reference: src/constructors.jl:25-27). linops_tpu keeps it on the
device:

1. ``format="auto"`` packs block-structured patterns to BSR and leaves
   scattered ones in CSR (one gather + segment sum);
2. ``format="routed"`` runs the radix-128 Clos pipeline by name;
3. ``opPermutation`` conjugates an operator (``reorder="rcm"`` recovers
   banding, so the band packs to BSR).

Run (CPU): python examples/09_unstructured_spmv.py
"""

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import scipy.sparse as sp

import linops_tpu as lo

rng = np.random.default_rng(0)
n = 4096

# --- a genuinely scattered matrix (16 random nnz per row) -------------------
A = sp.random(n, n, density=16 / n, format="csr", random_state=0)
A.data[:] = rng.standard_normal(A.nnz)

op = lo.opSparse(A, format="auto")  # scattered -> CSR
print(f"auto picked: {type(op).__name__}")

x = rng.standard_normal(n)
y = np.asarray(op * x)
print("forward  rel err:", np.linalg.norm(y - A @ x) / np.linalg.norm(A @ x))
yt = np.asarray(op.T * x)
print("adjoint  rel err:", np.linalg.norm(yt - A.T @ x) / np.linalg.norm(A.T @ x))

# sparse operators participate in the full algebra
chain = 2.0 * (op.T @ op) + lo.opEye(n)
z = np.asarray(chain * x)
ref = 2.0 * (A.T @ (A @ x)) + x
print("normal-equations chain rel err:", np.linalg.norm(z - ref) / np.linalg.norm(ref))

# --- permutations as first-class operators ----------------------------------
perm = rng.permutation(n)
P = lo.opPermutation(perm)
print("P x == x[perm]:", bool(np.array_equal(np.asarray(P * x), x[perm])))
print("Pᵀ P x == x   :", bool(np.allclose(np.asarray(P.T * (P * x)), x)))

# RCM conjugation: P A Pᵀ is banded for mesh-like patterns, and the whole
# conjugated operator is still a lazy graph applied on device
from linops_tpu.native import native_available, rcm_permutation

if native_available():
    mesh = sp.diags([np.ones(n - 64), np.ones(n), np.ones(n - 64)],
                    [-64, 0, 64], format="csr")
    rcm = rcm_permutation(mesh.indices, mesh.indptr, n)
    Pr = lo.opPermutation(np.asarray(rcm, np.int64))
    opm = lo.opSparse(mesh.tocsr(), format="csr")
    banded = Pr @ opm @ Pr.T
    got = np.asarray(banded * x)
    ref = mesh.toarray()[rcm][:, rcm] @ x
    print("RCM-conjugated apply rel err:",
          np.linalg.norm(got - ref) / np.linalg.norm(ref))

# One-keyword version: opSparse(reorder="rcm") computes the RCM
# permutation, reorders on the host, builds the inner operator through
# the normal auto-format pipeline (banded patterns land on BSR), and
# returns the sandwich Pᵀ·op(A[perm][:,perm])·P. Flags transfer: the
# sandwich of a
# symmetric operator is symmetric, so cg/lobpcg accept it directly.
if native_available():
    sigma = rng.permutation(n)
    scrambled = mesh[sigma][:, sigma].tocsr()
    op_re = lo.opSparse(scrambled, format="auto", reorder="rcm",
                        symmetric=True)
    got = np.asarray(op_re * x)
    print("reorder='rcm' inner:", type(op_re.inner).__name__,
          "| apply rel err:",
          np.linalg.norm(got - scrambled @ x) / np.linalg.norm(scrambled @ x))
