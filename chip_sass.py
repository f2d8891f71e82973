"""Count what the intersection kernels issue per (ray, triangle) pair.

Usage (on a machine with the CUDA toolkit; no GPU is needed):

    python3 chip_sass.py [--dump DIR] [--lib PATH]

Builds the port's kernel library (``ops/_build.py``), disassembles it with
``cuobjdump -sass`` and, for every instance of K1 (``nearest_kernel``), K2
(``occluded_kernel``), K4 and K5 (``*_culled_kernel``), finds the pair loop:
the innermost loop (backward branch) that holds at least one pair's 40
multiplies. Spans of it skipped by a forward branch and holding a
division, a call or a global load are the accept path, which few pairs
take; the rest is the path every pair takes. The pairs one pass handles
are that path's multiplies over 40 (four 10-term dots: 40 per pair, fused
or not; the margin test adds one or two, which the rounding absorbs). Prints, per kernel
instance, the instructions of that path per pair by class, and with
``--dump`` writes each instance's SASS to ``DIR``.

The bound of ``chip_smoke.py`` counts about 90 f32 operations per pair
over the 67 TFLOP/s peak, which counts a fused multiply-add as two: about
45 issue slots of an SM's 128 lanes per pair. A pair loop that issues n
instructions per pair can reach at most 45 / n of that bound.
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
           "occluded_culled_kernel")
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


def pair_loop(insns):
    """(pairs per pass, instructions on the common path, whole loop body)."""
    addr = [a for a, *_ in insns]
    best = None
    for i, (a, _, op, args) in enumerate(insns):
        t = TARGET.search(args)
        if not op.startswith("BRA") or not t or int(t.group(1), 16) > a:
            continue
        lo = addr.index(int(t.group(1), 16)) if int(t.group(1), 16) in addr else None
        if lo is None:
            continue
        body = insns[lo:i + 1]
        muls = sum(op2.split(".")[0] in ("FFMA", "FMUL") for _, _, op2, _ in body)
        if muls >= 40 and (best is None or len(body) < best[0]):
            best = (len(body), muls, lo, i)
    if best is None:
        return 0, [], []
    _, _, lo, hi = best
    body = insns[lo:hi + 1]
    cold = set()
    for j, (a, pred, op, args) in enumerate(body):
        t = TARGET.search(args)
        if not (op.startswith("BRA") and pred and t and int(t.group(1), 16) > a):
            continue
        span = [k for k in range(j + 1, len(body)) if body[k][0] < int(t.group(1), 16)]
        if any(body[k][2].split(".")[0] in COLD for k in span):
            cold.update(span)
    hot = [x for k, x in enumerate(body) if k not in cold]
    hot_muls = sum(op.split(".")[0] in ("FFMA", "FMUL") for _, _, op, _ in hot)
    return round(hot_muls / 40), hot, body


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
        tag = f"{kernel}<fma={inst.group(1)}>" if inst else kernel
        pairs, hot, body = pair_loop(insns)
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, re.sub(r"[^\w=,]", "_", tag) + ".sass"), "w") as f:
                f.write("\n".join(f"/*{a:04x}*/ {p} {o}{r};" for a, p, o, r in insns) + "\n")
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
        raise SystemExit("chip_sass: no intersection kernel in the library's SASS")


if __name__ == "__main__":
    main()
