from monte_carlo_path_tracing_tpu_torch.scene.types import (  # noqa: F401
    Camera, Materials, Scene, scene_from_arrays,
)
from monte_carlo_path_tracing_tpu_torch.scene.build import build_scene, load_scene  # noqa: F401
