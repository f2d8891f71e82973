"""Count what the kernels issue per (ray, triangle) pair and per Arvo weight.

Usage (on a machine with the CUDA toolkit; no GPU is needed):

    python3 chip_sass.py [--dump DIR] [--lib PATH]

Builds the port's kernel library (``ops/_build.py``), disassembles it with
``cuobjdump -sass`` and, for every instance of K1 (``nearest_kernel``), K2
(``occluded_kernel``), K4 and K5 (``*_culled_kernel``), finds the pair loop:
of the innermost loops (backward branches) that hold at least one pair's
40 multiplies, the one whose common path holds the most (a remainder copy
of the unrolled loop holds fewer). Spans of it skipped by a forward branch
and holding a division, a call or a global load are the accept path,
which few pairs take; the rest is the path every pair takes. The pairs one
pass handles are that path's multiplies over 40 (four 10-term dots: 40 per
pair, fused or not; the margin test adds one or two, which the rounding
absorbs). Prints, per kernel instance, the instructions of that path per
pair by class, and with ``--dump`` writes each instance's SASS to ``DIR``.

The bound of ``chip_smoke.py`` counts about 90 f32 operations per pair
over the 67 TFLOP/s peak, which counts a fused multiply-add as two: about
45 issue slots of an SM's 128 lanes per pair. A pair loop that issues n
instructions per pair can reach at most 45 / n of that bound.

For K3 (``arvo_select_kernel``) it finds the weight loop, the innermost
loop that holds one weight's three square roots (three ``MUFU.RSQ``) and
its atan2f, and the cull loop, the innermost loop without ``MUFU`` that
holds the cheap culls' four 3-term dots (12 multiplies a light). Spans
skipped by a forward branch and holding a call (the slow paths of the
square root and the division) are cold. It prints the instructions per
weight evaluated on the rest and per light culled, each with the share of
the bound that loop could reach at full issue: the bound counts 30
operations per (point, light) for the culls and 60 more per pair that
passes them (``chip_smoke.OPS``), so "at most 15 / n" for the cull loop
and "at most 30 / n" for the weight loop. The kernel's own ceiling lies
between them, weighted by the share of pairs that pass the culls, which
``chip_smoke.py`` prints.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess

from monte_carlo_path_tracing_tpu_torch.ops import _build

KERNELS = ("nearest_kernel", "occluded_kernel", "nearest_culled_kernel",
           "occluded_culled_kernel", "arvo_select_kernel")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
TARGET = re.compile(r"0x([0-9a-f]+)")
CLASSES = ("FFMA", "FMUL", "FADD", "FSETP", "LOP3", "LDS", "BRA", "PLOP3", "ISETP", "IADD3")
COLD = ("MUFU", "CALL", "LDG", "FCHK")


def cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ((CUDA_HOME and os.path.join(CUDA_HOME, "bin", "cuobjdump")),
                 shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("chip_sass: cuobjdump not found (needs the CUDA toolkit)")


def functions(sass: str) -> dict[str, list[tuple[int, str, str, str]]]:
    """Mangled name -> [(address, predicate, opcode, operands)]."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name is not None:
            m = INSN.search(line)
            if m:
                out[name].append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                                  m.group(4)))
    return out


def loops(insns):
    """(first, last) indices of every loop: a backward branch and its
    target."""
    addr = {a: i for i, (a, *_) in enumerate(insns)}
    out = []
    for i, (a, _, op, args) in enumerate(insns):
        t = TARGET.search(args)
        if op.startswith("BRA") and t and int(t.group(1), 16) <= a and int(t.group(1), 16) in addr:
            out.append((addr[int(t.group(1), 16)], i))
    return out


def count(body, ops) -> int:
    return sum(op.split(".")[0] in ops for _, _, op, _ in body)


def hot_path(body, cold_ops):
    """The loop body without, for each instruction of ``cold_ops``, the
    smallest span a forward branch skips that holds it."""
    spans = []
    for j, (a, pred, op, args) in enumerate(body):
        t = TARGET.search(args)
        if op.startswith("BRA") and pred and t and int(t.group(1), 16) > a:
            spans.append(range(j + 1, max([k + 1 for k in range(j + 1, len(body))
                                           if body[k][0] < int(t.group(1), 16)], default=j + 1)))
    cold = set()
    for k, (_, _, op, _) in enumerate(body):
        if op.split(".")[0] in cold_ops:
            inside = [s for s in spans if k in s]
            if inside:
                cold.update(min(inside, key=len))
    return [x for k, x in enumerate(body) if k not in cold]


def pair_loop(insns):
    """(pairs per pass, instructions on the common path, whole loop body) of
    the innermost loop with at least 40 multiplies whose common path holds
    the most (the unrolled pair loop, not a remainder copy of it)."""
    found = innermost([(lo, hi) for lo, hi in loops(insns)
                       if count(insns[lo:hi + 1], ("FFMA", "FMUL")) >= 40])
    if not found:
        return 0, [], []
    hots = [(count(hot, ("FFMA", "FMUL")), -(hi - lo), hot, insns[lo:hi + 1])
            for lo, hi in found for hot in [hot_path(insns[lo:hi + 1], COLD)]]
    muls, _, hot, body = max(hots, key=lambda h: h[:2])
    return round(muls / 40), hot, body


def innermost(spans):
    return [(lo, hi) for lo, hi in spans
            if not any((lo2, hi2) != (lo, hi) and lo <= lo2 and hi2 <= hi for lo2, hi2 in spans)]


def arvo_loops(insns):
    """K3: [(kind, units per pass, common path, whole body)] for the weight
    loops (kind "weight") and the cull loops ("light")."""
    out = []
    rsq = [(lo, hi) for lo, hi in loops(insns)
           if sum(op.startswith("MUFU.RSQ") for _, _, op, _ in insns[lo:hi + 1]) >= 3]
    for lo, hi in innermost(rsq):
        body = insns[lo:hi + 1]
        n = sum(op.startswith("MUFU.RSQ") for _, _, op, _ in body) // 3
        out.append(("weight", n, hot_path(body, ("CALL",)), body))
    cull = [(lo, hi) for lo, hi in loops(insns)
            if count(insns[lo:hi + 1], ("MUFU",)) == 0 and count(insns[lo:hi + 1], ("FMUL",)) >= 12]
    for lo, hi in innermost(cull):
        body = insns[lo:hi + 1]
        out.append(("light", count(body, ("FMUL",)) // 12, body, body))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", help="directory for each kernel instance's SASS")
    ap.add_argument("--lib", help="a built library to read (default: build the port's)")
    args = ap.parse_args()
    path = args.lib or str(_build.load().path)
    sass = subprocess.run([cuobjdump(), "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    found = 0
    for name, insns in sorted(functions(sass).items()):
        kernel = next((k for k in KERNELS if re.search(rf"\d{k}(I|E)", name)), None)
        if kernel is None:
            continue
        found += 1
        inst = re.search(r"ILb(\d)E", name)
        param = "staged" if kernel == "arvo_select_kernel" else "fma"
        tag = f"{kernel}<{param}={inst.group(1)}>" if inst else kernel
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, re.sub(r"[^\w=,]", "_", tag) + ".sass"), "w") as f:
                f.write("\n".join(f"/*{a:04x}*/ {p} {o}{r};" for a, p, o, r in insns) + "\n")
        if kernel == "arvo_select_kernel":
            found_loops = arvo_loops(insns)
            for kind, n, hot, body in found_loops:
                slots = {"weight": 30, "light": 15}[kind]    # chip_smoke.OPS / 2
                limit = f"; at most {slots / (len(hot) / n):.3f} of the bound"
                print(f"[sass] {tag}: {kind} loop at {body[0][0]:#06x}, {n} per pass; per {kind} "
                      f"{len(hot) / n:.2f} instructions on the common path ({len(body) / n:.2f} "
                      f"with the slow paths){limit}")
            if not any(kind == "weight" for kind, *_ in found_loops):
                print(f"[sass] {tag}: no weight loop found ({len(insns)} instructions)")
            continue
        pairs, hot, body = pair_loop(insns)
        if not pairs:
            print(f"[sass] {tag}: no pair loop found ({len(insns)} instructions)")
            continue
        cls = collections.Counter(op.split(".")[0] for _, _, op, _ in hot)
        counted = {c: cls[c] / pairs for c in CLASSES}
        other = (len(hot) - sum(cls[c] for c in CLASSES)) / pairs
        print(f"[sass] {tag}: {pairs} pairs per pass; per pair {len(hot) / pairs:.2f} instructions "
              f"on the common path ({len(body) / pairs:.2f} with the accept path): " +
              ", ".join(f"{c} {v:.2f}" for c, v in counted.items() if v) +
              f", other {other:.2f}; at most {45 / (len(hot) / pairs):.3f} of the bound")
    if not found:
        raise SystemExit("chip_sass: no kernel of the port in the library's SASS")


if __name__ == "__main__":
    main()
