from .render_sharded import (
    make_mesh,
    render_frame_sharded,
    render_frame_sharded_multi,
    render_sharded,
    shard_pod,
    slab_config,
)

__all__ = [
    "make_mesh",
    "render_frame_sharded",
    "render_frame_sharded_multi",
    "render_sharded",
    "shard_pod",
    "slab_config",
]
