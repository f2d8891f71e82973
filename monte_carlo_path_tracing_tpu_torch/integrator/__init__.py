from monte_carlo_path_tracing_tpu_torch.integrator.wavefront import render_rays  # noqa: F401
