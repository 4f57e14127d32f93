"""Time K10's two passes (csrc/rwkv6.cu) built with one part of the design
changed or cut, in turns, on the same tensors: where the time of each pass
goes.

  python3 tools/k10_ablate.py [--shapes 4x2048 1x8192]

Each variant is a copy of ``csrc/rwkv6.cu`` in the build directory with one
edit, compiled into a library of its own (the port's nvcc flags, ``-I``
``csrc/`` for its headers) and launched through its C entry points
(``rt_rwkv6_state``, ``rt_rwkv6_output``):

  base        csrc/rwkv6.cu as it is
  st_dt1      the state pass with 1 16-row tile of the state a block
  st_dt4      ... with 4 (``RT_K10_ST_DT``; the tree has 2)
  no_qs       the output pass without q S
  no_off      ... without A's factored off-diagonal blocks
  no_diag     ... without A's pairwise diagonal blocks
  no_av       ... without A v
  no_compute  ... without all four: the frame alone (staging, the scan of
              L, the bonus, the barriers, the stores)

At each shape (B x T, with H 64, dk = dv = 64, chunk 64) each pass is timed
alone on the bf16 (B, H, T, d) views the model's prefill passes and on fp32
(B H, T, d) tensors.  base and the st_dt variants must hold o and sT within
K10's tolerance (rtol 1e-5 + atol 2e-5 x max|plain|) of the plain version on
the fp32 tensors; the cut variants compute something else and are only
timed.  Inputs as chip_smoke.py's R1 makes them, drawn on the card; CUDA
events, median of 10, a call at a time; the variants in order, then in
reverse.  Prints the card's name and power limit, a line a variant and
shape, then one JSON line.  Needs a CUDA device; exits with 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

H, D, C = 64, 64, 64
RTOL, ATOL_REL = 1e-5, 2e-5
# (marker in csrc/rwkv6.cu, its replacement); each marker occurs once
QS = ("  for (int ks = 0; ks < RT_K10_MAX / 8; ++ks) {\n    rt_fa fa;\n#pragma unroll\n"
      "    for (int e = 0; e < 4; ++e) {\n      const int t = tA + ")
EDITS = {
    "st_dt1": [("#define RT_K10_ST_DT 2 ", "#define RT_K10_ST_DT 1 ")],
    "st_dt4": [("#define RT_K10_ST_DT 2 ", "#define RT_K10_ST_DT 4 ")],
    "no_qs": [(QS, QS.replace("ks < RT_K10_MAX / 8", "ks < 0"))],
    "no_off": [("  if (cnt > 0) {", "  if (false && cnt > 0) {")],
    "no_diag": [("    if (p >= RT_K10_SUB * (RT_K10_SUB - 1) / 2) continue;",
                 "    if (true) continue;")],
    "no_av": [("    if (ks >= 2 * (I + 1)) break;", "    break;")],
}
EDITS["no_compute"] = [e for k in ("no_qs", "no_off", "no_diag", "no_av") for e in EDITS[k]]
CHECKED = ("base", "st_dt1", "st_dt4")


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build(cuda, names):
    """One library a variant, all nvcc processes started together."""
    src = (cuda.CSRC / "rwkv6.cu").read_text()
    out = cuda.BUILD_DIR / "k10_ablate"
    out.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for name in names:
        text = src
        for old, new in EDITS.get(name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"csrc/rwkv6.cu: the marker of {name} occurs "
                                   f"{text.count(old)} times, not once: {old!r}")
            text = text.replace(old, new)
        path = out / f"rwkv6_{name}.cu"
        path.write_text(text)
        libs[name] = out / f"k10_{name}.so"
        cmds.append([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
                     str(libs[name]), str(path)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for c, p in zip(cmds, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{' '.join(c)}\n{log}")
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for sym in ("rt_rwkv6_state", "rt_rwkv6_output"):
            fn = getattr(lib, sym)
            fn.argtypes = list(cuda.SIGNATURES[sym])
            fn.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


class Passes:
    """The two passes of one variant on (B, H, T, d) operands of one dtype."""

    def __init__(self, r, k, v, w, u, s0):
        self.x, self.u, self.s0 = (r, k, v, w), u, s0
        B, _, T, _ = r.shape
        dev = r.device
        self.dims = (B, H, T, C, D, D)
        self.states = torch.empty((B * H, T // C, D, D), device=dev)
        self.sT = torch.empty((B, H, D, D), device=dev)
        self.o = torch.empty((B, H, T, D), dtype=r.dtype, device=dev)
        self.bf16 = int(r.dtype == torch.bfloat16)

    def state(self, lib):
        r, k, v, w = self.x
        rc = lib.rt_rwkv6_state(k.data_ptr(), v.data_ptr(), w.data_ptr(), self.s0.data_ptr(),
                                self.states.data_ptr(), self.sT.data_ptr(), *self.dims,
                                *r.stride()[:3], *v.stride()[:3], self.bf16,
                                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"rt_rwkv6_state: CUDA error {rc}"

    def output(self, lib):
        r, k, v, w = self.x
        rc = lib.rt_rwkv6_output(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                 self.u.data_ptr(), self.states.data_ptr(), self.o.data_ptr(),
                                 *self.dims, *r.stride()[:3], *v.stride()[:3], 0,
                                 self.u.stride(0), *self.o.stride()[:3], self.bf16, self.bf16,
                                 torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"rt_rwkv6_output: CUDA error {rc}"


def problem(gen, B, T):
    """R1's inputs (strong decay w = exp(-exp(1 + N(0, 1))), a random u and
    s0), fp32 (B, H, T, d), and their bf16 (B, H, T, d) views of (B, T, H, d)."""
    def n(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")
    r, k, v = n(B, H, T, D), n(B, H, T, D, scale=0.3), n(B, H, T, D)
    w = torch.exp(-torch.exp(1.0 + n(B, H, T, D)))
    u, s0 = n(H, D, scale=0.5), n(B, H, D, D, scale=0.1)
    views = [x.transpose(1, 2).to(torch.bfloat16).contiguous().transpose(1, 2)
             for x in (r, k, v, w)]
    return Passes(r, k, v, w, u, s0), Passes(*views, u, s0)


def close(got, want, what):
    err = (got - want).abs()
    if not bool((err <= ATOL_REL * want.abs().max() + RTOL * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {err.max().item()} beyond K10's tolerance")
    return err.max().item()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["4x2048", "1x8192"],
                    help="B x T at H 64, d 64, chunk 64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch import _cuda
    from repro_torch.kernels.rwkv6_scan import kernel as k10

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    names = ["base", *EDITS]
    t0 = time.perf_counter()
    libs = build(_cuda, names)
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(libs)} variants", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    result = {}
    for shape in args.shapes:
        B, T = (int(x) for x in shape.split("x"))
        f32, b16 = problem(gen, B, T)
        r, k, v, w = (x.reshape(B * H, T, D) for x in f32.x)
        o_p, s_p = k10.rwkv6_plain(r, k, v, w, f32.u.repeat(B, 1),
                                   f32.s0.reshape(B * H, D, D), chunk=C)
        for name in CHECKED:
            f32.state(libs[name])
            f32.output(libs[name])
            err = max(close(f32.o.reshape(B * H, T, D), o_p, f"{name} o at {shape}"),
                      close(f32.sT.reshape(B * H, D, D), s_p, f"{name} sT at {shape}"))
            print(f"{name} at {shape}: o and sT within K10's tolerance, max abs err {err:.3e}",
                  flush=True)
        del o_p, s_p
        times = {n: {} for n in names}
        for name in names + names[::-1]:
            lib = libs[name]
            for tag, p in (("bf16", b16), ("fp32", f32)):
                for what in ("state", "output"):
                    fn = getattr(p, what)
                    times[name].setdefault(f"{tag}_{what}_ms", []).append(
                        time_ms(lambda: fn(lib)))
        for name in names:
            t = times[name]
            print(f"{name:10s} {shape}: bf16 state {t['bf16_state_ms']}, output "
                  f"{t['bf16_output_ms']}; fp32 state {t['fp32_state_ms']}, output "
                  f"{t['fp32_output_ms']} ms (in turns)", flush=True)
        result[shape] = times
        del f32, b16
        torch.cuda.empty_cache()
    print(json.dumps({"k10_ablate": {"card": smi, "shapes": result}}))


if __name__ == "__main__":
    main()
