from .sharding import make_mesh, make_train_step, render_image_sharded, replicate_scene

__all__ = ["make_mesh", "make_train_step", "render_image_sharded", "replicate_scene"]
