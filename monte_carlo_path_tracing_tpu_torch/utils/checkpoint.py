"""Progressive render checkpoints.

Counterpart of ``monte_carlo_path_tracing_tpu/utils/checkpoint.py``, in the
same npz layout (``framebuffer_sum``, ``spp_done``, ``seed``, and ``config``
as JSON bytes), so a checkpoint written by either package resumes in the
other. The summed framebuffer and the number of completed spp are the whole
state: the streams are keyed by (seed, spp index, pixel), so resuming at
``spp_done`` continues the render exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

#: The configuration fields that change the estimate: a checkpoint resumes
#: only into a configuration that agrees on all of them.
COMPAT_KEYS = ("width", "height", "estimator", "light_sampler", "rr_prob", "max_depth",
               "seed", "pixel_jitter")


@dataclasses.dataclass
class RenderCheckpoint:
    framebuffer_sum: np.ndarray  # [H, W, 3] radiance summed over completed spp
    spp_done: int
    seed: int
    config: dict

    def mean_image(self) -> np.ndarray:
        return self.framebuffer_sum / max(self.spp_done, 1)


def savez_atomic(path: str, **arrays) -> None:
    """``np.savez_compressed`` to exactly ``path``, atomically: written to a
    temporary file beside it, then renamed over it, so a run killed while
    writing leaves the previous file whole."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save(path: str, ckpt: RenderCheckpoint) -> None:
    savez_atomic(
        path,
        framebuffer_sum=np.asarray(ckpt.framebuffer_sum, np.float32),
        spp_done=np.int64(ckpt.spp_done),
        seed=np.int64(ckpt.seed),
        config=np.frombuffer(json.dumps(ckpt.config).encode(), dtype=np.uint8),
    )


def load(path: str) -> RenderCheckpoint:
    with np.load(path) as z:
        return RenderCheckpoint(
            framebuffer_sum=z["framebuffer_sum"],
            spp_done=int(z["spp_done"]),
            seed=int(z["seed"]),
            config=json.loads(bytes(z["config"]).decode()),
        )


def config_dict(cfg: RenderConfig) -> dict:
    return dataclasses.asdict(cfg)


def check_compatible(ckpt: RenderCheckpoint, cfg: RenderConfig) -> None:
    """Raise ValueError if ``cfg`` changes the estimate the checkpoint holds."""
    old, new = ckpt.config, config_dict(cfg)
    for k in COMPAT_KEYS:
        if old.get(k) != new.get(k):
            raise ValueError(f"checkpoint incompatible: {k} was {old.get(k)}, now {new.get(k)}")
