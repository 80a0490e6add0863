"""paddle_tpu_torch.parallel — distribution (this slice: the link model the
disaggregated server prices its KV hand-offs with,
:func:`~paddle_tpu_torch.parallel.planner.link_bandwidth`). The mesh, the
collectives, the fleet and the parallel layers of ``paddle_tpu/parallel``
are ROADMAP.md Queue A item 19."""
from . import planner
from .planner import link_bandwidth

__all__ = ["planner", "link_bandwidth"]
