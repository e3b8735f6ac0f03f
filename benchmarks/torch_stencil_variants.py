#!/usr/bin/env python3
"""K1 and its dw kernel at several tilings, on one CUDA card.

Builds ``graphgp_tpu_torch/csrc/stencil.cu`` once per setting below (a copy
with the tile widths of ``tile_for`` and kThreads replaced, one nvcc each,
all started together) and times the product and the dw kernel at the flagship
grid's shape (S = 41 offsets dx + 1000·dy with |dx| + |dy| ≤ 4, N = 1e6) for
B in 1, 8, 12, 14, 16, each checked against the plain versions first. CUDA events,
50 launches after 5 warm-ups, the settings in turns (forward, then reverse
order) so every setting sees the same card state. The shipped setting is
the first.

Usage, from the repository root: python3 benchmarks/torch_stencil_variants.py
"""
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, ".")
from graphgp_tpu_torch.cuda_kernels import _build  # noqa: E402
from graphgp_tpu_torch.cuda_kernels import stencil as k1  # noqa: E402

N = 1_000_000
# (wide tile, narrow tile, kThreads); the first is the shipped one
SETTINGS = [(256, 128, 128), (256, 256, 128), (128, 128, 128), (512, 256, 256)]
BATCHES = (1, 8, 12, 14, 16)
OFFSETS = tuple(sorted(dx + 1000 * dy for dx in range(-4, 5) for dy in range(-4, 5)
                       if abs(dx) + abs(dy) <= 4))


def _wide(b: int) -> bool:
    """Whether the shipped planner gives B rows the wide tile."""
    return k1.BandPlan.tile(b) == 256


def build(tmp: str):
    src = open(os.path.join(_build.CSRC, "stencil.cu")).read()
    procs = []
    for small, large, threads in SETTINGS:
        body = re.sub(r"return B <= (\d+) \? \d+ : \d+;",
                      lambda m: f"return B <= {m.group(1)} ? {small} : {large};", src)
        body = re.sub(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", body)
        path = os.path.join(tmp, f"stencil_{small}_{large}_{threads}.cu")
        with open(path, "w") as fh:
            fh.write(body)
        out = path[:-3] + ".so"
        procs.append((out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    libs = []
    for setting, (out, proc) in zip(SETTINGS, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {setting}:\n{log}")
        regs = {m.group(1): m.group(2) for m in re.finditer(
            r"entry function '\S*?\d(stencil_\w+_kernelILi(?:1|8|16)EE)\S*'.*?Used (\d+) registers",
            log, re.S)}
        print(f"tiles {setting[:2]}, kThreads={setting[2]}: registers {regs}", flush=True)
        lib = ctypes.CDLL(out)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.stencil_matvec_f32.argtypes = [p, p, p, p, i, i, i, i, ll, i, ll, p]
        lib.stencil_dw_f32.argtypes = [p, p, p, p, i, i, i, ll, i, ll, p]
        libs.append(lib)
    return libs


def ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stencil_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
    dev = torch.device("cuda")
    plan = k1.plan_bands(OFFSETS)
    table = torch.from_numpy(plan.table).to(dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    w = torch.randn(len(OFFSETS), N, device=dev)

    def product(lib, setting, v, out):
        b = v.shape[0]
        tile = setting[0] if _wide(b) else setting[1]
        smem = 4 * (2 * (b * (tile + k1.WINDOW_PAD) + plan.band_rows * tile) + table.numel())
        rc = lib.stencil_matvec_f32(w.data_ptr(), v.data_ptr(), out.data_ptr(), table.data_ptr(),
                                    table.numel(), len(OFFSETS), plan.band_rows, b, N, tile, smem,
                                    stream)
        assert rc == 0, rc

    def dw(lib, setting, v, g, out):
        b = v.shape[0]
        tile = setting[0] if _wide(b) else setting[1]
        smem = 4 * (2 * b * (tile + k1.WINDOW_PAD) + table.numel())
        rc = lib.stencil_dw_f32(v.data_ptr(), g.data_ptr(), out.data_ptr(), table.data_ptr(),
                                table.numel(), len(OFFSETS), b, N, tile, smem, stream)
        assert rc == 0, rc

    for b in BATCHES:
        v, g = torch.randn(b, N, device=dev), torch.randn(b, N, device=dev)
        out, dwo = torch.empty_like(v), torch.empty_like(w)
        ref, ref_dw = k1.matvec_plain(w, v, OFFSETS), k1._dw_matvec(v, g, OFFSETS)
        for lib, setting in zip(libs, SETTINGS):
            product(lib, setting, v, out)
            dw(lib, setting, v, g, dwo)
            torch.cuda.synchronize()
            assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
            assert float((dwo - ref_dw).abs().max() / ref_dw.abs().max()) <= 1e-5
        times = {s: [] for s in SETTINGS}
        for order in (SETTINGS, SETTINGS[::-1]):
            for s in order:
                lib = libs[SETTINGS.index(s)]
                times[s].append((ms(lambda: product(lib, s, v, out)),
                                 ms(lambda: dw(lib, s, v, g, dwo))))
        bound = 4.0 * (len(OFFSETS) * N + 2 * b * N) / 3.35e12 * 1e3
        for (small, large, threads), t in times.items():
            print(f"B={b} tile {small if _wide(b) else large} kThreads={threads}: K1 "
                  f"{' / '.join(f'{x[0]:.4f}' for x in t)} ms, dw "
                  f"{' / '.join(f'{x[1]:.4f}' for x in t)} ms (bound {bound:.4f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
