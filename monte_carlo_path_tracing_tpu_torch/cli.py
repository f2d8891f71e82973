"""Command-line entry point of the PyTorch/CUDA port: the JAX package's CLI
(``monte_carlo_path_tracing_tpu/cli.py``) with the same subcommands, flags,
defaults and last-line JSON.

Usage examples (on the card; add ``--cpu`` to run on the CPU):
    python -m monte_carlo_path_tracing_tpu_torch.cli render scenes/cornell/cornell.obj \\
        --spp 64 --estimator mis --out out.png
    python -m monte_carlo_path_tracing_tpu_torch.cli render scenes/veach-mis/veach-mis.obj \\
        --spp 10 --out test.bmp --checkpoint ckpt.npz --checkpoint-every 4 [--resume]
    python -m monte_carlo_path_tracing_tpu_torch.cli render scenes/veach-mis/veach-mis.obj \\
        --regen --spp 8 --max-depth 16 --lanes 65536 --out v.npy
    python -m monte_carlo_path_tracing_tpu_torch.cli inverse scenes/cornell/cornell.obj \\
        --steps 200 --perturb 0.2

Scenes load onto the card unless ``--cpu`` asks for the CPU; without a card
and without ``--cpu`` the command fails. ``--ref-mis-full`` sets
``ref_mis_weights`` and ``mis_blocker_compat`` and forces ``--regen`` for
``render``, as in the JAX CLI; where the JAX CLI fails on a combination
(``inverse --ref-mis-full``: the blocker queue is a regen feature;
``inverse --accel grid``: no gradient through the grid) the port fails
the same way. With ``--cpu``, ``--impl matmul`` and ``--no-fused-arvo``
run: they name the plain intersection and the plain Arvo pick, which is
what the port runs on the CPU anyway. Flags whose code the port does not
run exit non-zero, before any scene loads, with a message naming the
ROADMAP item: ``--impl pallas`` and ``--dot-mode`` with any value (the
port's kernels are exact f32 CUDA), ``--impl matmul`` and
``--no-fused-arvo`` on the card (there K1 / K2 and the K3 kernel always
run) and ``--fused-arvo`` with ``--cpu`` (no kernel runs on the CPU).
Like the JAX CLI, ``main()`` first calls ``init_distributed_if_needed``
(``parallel/mesh.py``): under torchrun's or SLURM's variables it joins the
process group (NCCL; gloo with ``--cpu``), and otherwise does nothing. Each
process then renders as it does alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

DO_NOT_PORT = 'ROADMAP queue 1, "Do not port"'


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="path to <scene>.obj (xml/mtl beside it)")
    p.add_argument("--xml", default=None, help="override scene xml path")
    p.add_argument("--width", type=int, default=None, help="override xml width")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--estimator", default="mis", choices=["brdf", "split", "mis", "shoot"])
    p.add_argument("--light-sampler", default="spherical_triangle",
                   choices=["uniform_area", "spherical_triangle"])
    p.add_argument("--rr", type=float, default=0.6, help="RR survival prob")
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-radiance", type=float, default=380.0)
    p.add_argument("--gamma", type=float, default=0.25)
    p.add_argument("--jitter", action="store_true", help="sub-pixel AA jitter")
    p.add_argument("--ray-chunk", type=int, default=1 << 16)
    p.add_argument("--distance-scale", type=float, default=1.0,
                   help="push the eye to Nx the lookat distance (reference '2x distance')")
    p.add_argument("--fov-bug-compat", action="store_true")
    p.add_argument("--measure-bug-compat", action="store_true")
    p.add_argument("--branch-pdf-compat", action="store_true")
    p.add_argument("--ref-mis-weights", action="store_true")
    p.add_argument("--ref-mis-full", action="store_true",
                   help="full reference MIS parity: ref weights + occluded-blocker recursion "
                        "via the regen work queue (implies --ref-mis-weights and --regen)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--impl", default=None, choices=[None, "pallas", "matmul"],
                   help="matmul = the plain intersection, with --cpu only; pallas = the TPU "
                        f"kernels, not ported ({DO_NOT_PORT})")
    p.add_argument("--accel", default="auto", choices=["auto", "all_pairs", "grid"],
                   help="auto = all pairs, with the loop's lane sort and culled traces "
                        "on scenes of 24,000 triangles or more; grid = the reference's "
                        "uniform grid + 3D-DDA (fixed-depth traces; the regen loop runs "
                        "all pairs)")
    p.add_argument("--dot-mode", default=None, choices=[None, "vpu", "mxu", "mxu_fast"],
                   help=f"TPU dot modes; not ported ({DO_NOT_PORT})")
    p.add_argument("--primary-cache", default=None, action="store_true",
                   help="cache per-pixel primary hits + depth-0 Arvo prepare across spp "
                        "(default auto: on when eligible)")
    p.add_argument("--no-primary-cache", dest="primary_cache", action="store_false")
    p.add_argument("--ray-sort", action="store_true",
                   help="regen lane coherence sort (pure permutation)")
    p.add_argument("--fused-arvo", default=None, action="store_true",
                   help="the K3 Arvo pick kernel (the default on the card)")
    p.add_argument("--no-fused-arvo", dest="fused_arvo", action="store_false",
                   help=f"the plain Arvo pick, with --cpu only ({DO_NOT_PORT} on the card)")


def _unsupported(args) -> str | None:
    """The message for a flag the port does not run, or None."""
    bad = [
        (args.impl == "pallas", f"--impl pallas (TPU intersection; {DO_NOT_PORT})"),
        (args.impl == "matmul" and not args.cpu,
         "--impl matmul without --cpu (would put the plain intersection on the card's "
         f"main path; {DO_NOT_PORT})"),
        (args.dot_mode is not None, f"--dot-mode {args.dot_mode} (TPU dot modes; {DO_NOT_PORT})"),
        (args.fused_arvo is False and not args.cpu,
         "--no-fused-arvo without --cpu (would put the plain Arvo pick on the card's main "
         f"path; {DO_NOT_PORT})"),
        (args.fused_arvo is True and args.cpu,
         "--fused-arvo with --cpu (the K3 kernel runs only on the card)"),
    ]
    for is_bad, what in bad:
        if is_bad:
            return f"not supported by the PyTorch/CUDA port: {what}"
    return None


def _load_scene(args):
    from monte_carlo_path_tracing_tpu_torch.render.camera import push_back_camera
    from monte_carlo_path_tracing_tpu_torch.scene import load_scene

    scene = load_scene(args.scene, args.xml, fov_bug_compat=args.fov_bug_compat,
                       device="cpu" if args.cpu else "cuda")
    cam = scene.camera
    if args.width or args.height:
        cam = dataclasses.replace(cam, width=args.width or cam.width,
                                  height=args.height or cam.height)
    if args.distance_scale != 1.0:
        cam = push_back_camera(cam, args.distance_scale)
    return dataclasses.replace(scene, camera=cam)


def _make_cfg(args, cam):
    from monte_carlo_path_tracing_tpu_torch.utils.config import RenderConfig

    return RenderConfig(
        width=cam.width, height=cam.height, spp=args.spp,
        estimator=args.estimator, light_sampler=args.light_sampler,
        rr_prob=args.rr, max_depth=args.max_depth,
        max_radiance=args.max_radiance, gamma=args.gamma, seed=args.seed,
        pixel_jitter=args.jitter, ray_chunk=args.ray_chunk,
        fov_bug_compat=args.fov_bug_compat,
        measure_bug_compat=args.measure_bug_compat,
        branch_pdf_compat=args.branch_pdf_compat,
        ref_mis_weights=args.ref_mis_weights or args.ref_mis_full,
        mis_blocker_compat=args.ref_mis_full,
        accel=args.accel, ray_sort=args.ray_sort,
        primary_cache=args.primary_cache,
    )


def cmd_render(args) -> int:
    from monte_carlo_path_tracing_tpu_torch.render import film
    from monte_carlo_path_tracing_tpu_torch.render.renderer import (
        render_image, render_image_regen,
    )
    from monte_carlo_path_tracing_tpu_torch.utils import checkpoint as ckpt_mod

    scene = _load_scene(args)
    cfg = _make_cfg(args, scene.camera)

    start_spp, fb = 0, None
    if args.checkpoint and args.resume:
        try:
            ck = ckpt_mod.load(args.checkpoint)
            ckpt_mod.check_compatible(ck, cfg)
            start_spp, fb = ck.spp_done, ck.framebuffer_sum
            print(f"resuming from {args.checkpoint} at spp={start_spp}")
        except FileNotFoundError:
            pass

    if args.ref_mis_full:
        args.regen = True   # the blocker queue lives in the regen renderer
    if args.regen:
        on_launch = None
        if args.preview:
            # The accumulating image after every launch (the reference's
            # per-scanline framebuffer flush, main.cpp:587).
            def on_launch(img, spp_done):
                film.write_image(args.preview, img, cfg.max_radiance, cfg.gamma)
                print(f"preview @ spp {spp_done} -> {args.preview}", file=sys.stderr, flush=True)

        kw = {}
        if args.preview_every:
            kw["max_samples_per_launch"] = (
                scene.camera.height * scene.camera.width * args.preview_every)
        r = render_image_regen(scene, cfg, lanes=args.lanes, on_launch=on_launch, **kw)
        image, seconds = r.image, r.seconds
    elif args.checkpoint and args.checkpoint_every:
        # spp segments, the summed framebuffer saved atomically after each.
        h, w = scene.camera.height, scene.camera.width
        fb_sum = np.zeros((h, w, 3), np.float32) if fb is None else fb.copy()
        s = start_spp
        seconds = 0.0
        while s < cfg.spp:
            step = min(args.checkpoint_every, cfg.spp - s)
            r = render_image(scene, cfg.replace(spp=s + step), start_spp=s, framebuffer=fb_sum)
            fb_sum = r.image * (s + step)
            seconds += r.seconds
            s += step
            ckpt_mod.save(args.checkpoint, ckpt_mod.RenderCheckpoint(
                framebuffer_sum=fb_sum, spp_done=s, seed=cfg.seed,
                config=ckpt_mod.config_dict(cfg)))
            print(f"spp {s}/{cfg.spp} (checkpointed)", file=sys.stderr, flush=True)
        image = fb_sum / cfg.spp
    else:
        r = render_image(
            scene, cfg, start_spp=start_spp, framebuffer=fb,
            progress=lambda s, t: print(f"spp {s}/{t}", file=sys.stderr, flush=True),
        )
        image, seconds = r.image, r.seconds

    if args.out:
        film.write_image(args.out, image, cfg.max_radiance, cfg.gamma)
        print(f"wrote {args.out}")
    print(json.dumps({
        "seconds": round(seconds, 3),
        "spp": cfg.spp,
        "mean_radiance": float(np.mean(image)),
    }))
    return 0


def perturb_materials(m, perturb: float, fams):
    """The inverse demo's start: every optimised family moved off its true
    value (kd up, non-zero ks down, ns x 0.4, emission x 0.5); the rest
    keep their true values."""
    return dataclasses.replace(
        m,
        kd=torch.clamp(m.kd + perturb, 0.02, 0.95) if "kd" in fams else m.kd,
        ks=torch.clamp(m.ks - perturb * (m.ks > 0), 0.0, 0.95) if "ks" in fams else m.ks,
        ns=m.ns * 0.4 if "ns" in fams else m.ns,
        emission=m.emission * 0.5 if "emission" in fams else m.emission,
    )


def material_errors(got, true) -> dict:
    """The inverse demo's scores: mean absolute kd / ks error, mean |log|
    ns ratio, and the relative radiance error over emitting materials."""
    mae = lambda a, b: float(torch.mean(torch.abs(a - b)))  # noqa: E731
    em_t, em_g = true.emission.sum(-1), got.emission.sum(-1)
    return {
        "kd_mae": mae(got.kd, true.kd),
        "ks_mae": mae(got.ks, true.ks),
        "ns_rel_mae": float(torch.mean(torch.abs(torch.log(got.ns / true.ns)))),
        "emission_rel_mae": float(torch.mean(torch.where(
            em_t > 0, torch.abs(em_g - em_t) / torch.clamp(em_t, min=1e-9),
            torch.zeros_like(em_t)))),
    }


def cmd_inverse(args) -> int:
    from monte_carlo_path_tracing_tpu_torch.diff.inverse import recover_materials

    scene = _load_scene(args)
    cfg = _make_cfg(args, scene.camera)
    fams = tuple(args.optimize.split(","))
    m = scene.materials
    res = recover_materials(
        scene, perturb_materials(m, args.perturb, fams), cfg, steps=args.steps, lr=args.lr,
        rays_per_step=args.rays_per_step, seed=args.seed, optimize=fams,
        progress=lambda i, loss: (print(f"step {i} loss {loss:.6f}", file=sys.stderr,
                                        flush=True) if i % 10 == 0 else None),
    )
    out = {"final_loss": res.losses[-1], "steps": res.steps}
    out.update(material_errors(res.materials, m))
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    # Multi-process bring-up first (a no-op unless a launcher set the
    # variables), as the JAX CLI does.
    from monte_carlo_path_tracing_tpu_torch.parallel.mesh import init_distributed_if_needed

    init_distributed_if_needed("gloo" if "--cpu" in (sys.argv[1:] if argv is None else argv)
                               else "nccl")

    ap = argparse.ArgumentParser(prog="monte_carlo_path_tracing_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a cg23 scene")
    _add_render_args(pr)
    pr.add_argument("--out", default=None, help=".png/.bmp/.npy output")
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--checkpoint-every", type=int, default=0)
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--regen", action="store_true",
                    help="path-regeneration renderer (fastest forward path; no checkpointing)")
    pr.add_argument("--lanes", type=int, default=1 << 16, help="wavefront lanes for --regen")
    pr.add_argument("--preview", default=None, metavar="PATH",
                    help="with --regen: write the accumulating image here after every launch")
    pr.add_argument("--preview-every", type=int, default=0, metavar="SPP",
                    help="with --preview: cap launches to SPP samples/pixel")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("inverse", help="inverse-rendering recovery demo")
    _add_render_args(pi)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=0.1)
    pi.add_argument("--perturb", type=float, default=0.2)
    pi.add_argument("--rays-per-step", type=int, default=1024)
    pi.add_argument("--optimize", default="kd,ks,ns,emission",
                    help="comma list of material families to recover")
    pi.set_defaults(fn=cmd_inverse)

    args = ap.parse_args(argv)
    msg = _unsupported(args)
    if msg is not None:
        print(f"{ap.prog}: {msg}", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
