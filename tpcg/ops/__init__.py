from .cplx import (to_planes, from_planes, cmul, cdiv, cabs,      # noqa: F401
                   udot_planes, PairOperator, make_pair_operator,
                   block_cg_planes, block_cg_planes_chunked,
                   CGPlanesResult)
from .auto import plan_stencil_cg, stencil_cg, StencilCGPlan     # noqa: F401
