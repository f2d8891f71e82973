from monte_carlo_path_tracing_tpu_torch.diff.grad import (  # noqa: F401
    LatentMaterials, from_latent, loss_and_grad, pixel_grad, render_loss, to_latent,
)
