"""tpcg -- block conjugate-gradient solver framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the
``conjugate-gradient-pyopencl`` reference (GPU block-CG over CSR + 2-D
Helmholtz FE problem suite + MPI domain-decomposition ORAS/FGMRES solver).
See SURVEY.md for the layer map and parity table.
"""

from .cg import block_cg, cg_solve, udot, CGResult            # noqa: F401
from .api import cg, cg_matrix                                # noqa: F401
from .ops.auto import plan_stencil_cg, stencil_cg             # noqa: F401
from .sparse import (DiaMatrix, EllMatrix, Stencil2D,         # noqa: F401
                     to_device_matrix)
from . import reference                                       # noqa: F401
from . import problems                                        # noqa: F401

__version__ = "0.1.0"
