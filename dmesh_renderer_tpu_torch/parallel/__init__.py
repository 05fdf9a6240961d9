"""Multi-view training over ``torch.distributed``: the view mesh
(``sharding``) and the local processes that form one (``launch``)."""

from .launch import default_backend, spawn
from .sharding import (
    VIEW_AXIS,
    ViewMesh,
    all_reduce,
    barrier,
    graph_capturable,
    make_view_mesh,
    replicate_params,
    shard_view_batch,
)

__all__ = ["VIEW_AXIS", "ViewMesh", "all_reduce", "barrier",
           "default_backend", "graph_capturable", "make_view_mesh",
           "replicate_params", "shard_view_batch", "spawn"]
