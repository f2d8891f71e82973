"""Launchers, loaded by the name a traffic mix gives as ``launcher``:
``single`` (one card, ``render.renderer.render_image_regen``) and
``sharded`` (one process per card, ``parallel.sharded.make_regen_sharded``).
A new launch driver is a new module here, with ``run(cell, seed, seconds,
traced, clock, device)``."""
