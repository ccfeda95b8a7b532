"""Sparse storage formats and operators (SURVEY.md §2.3: 'Sparse storage
formats')."""

from .formats import COO, CSR, BSR, ELL, coo_from_dense, csr_from_dense, bsr_from_dense, ell_from_dense, ell_from_csr_parts
from .ops import (COOOperator, CSROperator, RoutedCSROperator,
                  BSROperator, ELLOperator, opSparse)
from .reorder import ReorderedOperator
from .dia import DIAOperator, opDIA, dia_from_dense, laplacian_1d, laplacian_2d, laplacian_2d_dia
from .stencil import StencilOperator, Stencil2DOperator, opStencil2D, opStencil

__all__ = [
    "COO",
    "CSR",
    "BSR",
    "ELL",
    "coo_from_dense",
    "csr_from_dense",
    "bsr_from_dense",
    "ell_from_dense",
    "ell_from_csr_parts",
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
]
