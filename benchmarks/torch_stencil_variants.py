#!/usr/bin/env python3
"""K1, its dw kernel, K2a and K2b at several tilings, on one CUDA card.

Builds ``graphgp_tpu_torch/csrc/stencil.cu`` and ``gram.cu`` once per
setting below, against a copy of their shared header ``bands.cuh`` with the
tile widths of ``tile_for`` and kThreads replaced (one nvcc each, all
started together), and times the four kernels at the flagship grid's shape
(S = 41 offsets dx + 1000·dy with |dx| + |dy| ≤ 4, N = 1e6; K2 with mask =
every second node) for B in 1, 8, 12, 14, 16, each checked against the plain
versions first. CUDA events, 50 launches after 5 warm-ups, the settings in
turns (forward, then reverse order) so every setting sees the same card
state. The shipped setting is the first.

Usage, from the repository root: python3 benchmarks/torch_stencil_variants.py
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, ".")
from graphgp_tpu_torch.cuda_kernels import _build  # noqa: E402
from graphgp_tpu_torch.cuda_kernels import gram as k2  # noqa: E402
from graphgp_tpu_torch.cuda_kernels import stencil as k1  # noqa: E402

N = 1_000_000
# (wide tile, narrow tile, kThreads); the first is the shipped one
SETTINGS = [(256, 128, 128), (256, 256, 128), (128, 128, 128), (512, 256, 256)]
BATCHES = (1, 8, 12, 14, 16)
OFFSETS = tuple(sorted(dx + 1000 * dy for dx in range(-4, 5) for dy in range(-4, 5)
                       if abs(dx) + abs(dy) <= 4))
NEG = tuple(-o for o in OFFSETS)


def _wide(b: int) -> bool:
    """Whether the shipped planner gives B rows the wide tile."""
    return k1.BandPlan.tile(b) == 256


def build(tmp: str):
    header = open(os.path.join(_build.CSRC, "bands.cuh")).read()
    procs = []
    for small, large, threads in SETTINGS:
        body = re.sub(r"return B <= (\d+) \? \d+ : \d+;",
                      lambda m: f"return B <= {m.group(1)} ? {small} : {large};", header)
        body = re.sub(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};",
                      body)
        folder = os.path.join(tmp, f"tiles_{small}_{large}_{threads}")
        os.makedirs(folder)
        with open(os.path.join(folder, "bands.cuh"), "w") as fh:
            fh.write(body)
        sources = []
        for name in ("stencil.cu", "gram.cu"):
            sources.append(shutil.copy(os.path.join(_build.CSRC, name), folder))
        out = os.path.join(folder, "kernels.so")
        procs.append((out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                                             *sources],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    libs = []
    for setting, (out, proc) in zip(SETTINGS, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {setting}:\n{log}")
        regs = {m.group(1): m.group(2) for m in re.finditer(
            r"entry function '\S*?\d((?:stencil|gram)_\w+_kernelILi(?:1|8|16)EE)\S*'.*?"
            r"Used (\d+) registers", log, re.S)}
        print(f"tiles {setting[:2]}, kThreads={setting[2]}: registers {regs}", flush=True)
        lib = ctypes.CDLL(out)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.stencil_matvec_f32.argtypes = [p, p, p, p, i, i, i, i, ll, i, ll, p]
        lib.stencil_dw_f32.argtypes = [p, p, p, p, i, i, i, ll, i, ll, p]
        lib.gram_rmv_mask_f32.argtypes = [p, p, p, p, p, i, i, i, i, ll, i, ll, p]
        lib.gram_mv_epilogue_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ll, i, ll, p]
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
    plan, plan_neg = k1.plan_bands(OFFSETS), k1.plan_bands(NEG)
    table = torch.from_numpy(plan.table).to(dev)
    table_neg = torch.from_numpy(plan_neg.table).to(dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    w = torch.randn(len(OFFSETS), N, device=dev)
    w_shift = k1.shifted_weights(w, OFFSETS).contiguous()
    mask = torch.zeros(N, device=dev)
    mask[::2] = 1.0
    nv = torch.tensor([0.1], device=dev)

    def tile_of(setting, b):
        return setting[0] if _wide(b) else setting[1]

    def stage(b, tile, rows, band_rows):
        return 4 * (2 * (rows * (tile + k1.WINDOW_PAD) + band_rows * tile))

    def product(lib, setting, v, out):
        b = v.shape[0]
        tile = tile_of(setting, b)
        smem = stage(b, tile, b, plan.band_rows) + 4 * table.numel()
        rc = lib.stencil_matvec_f32(w.data_ptr(), v.data_ptr(), out.data_ptr(), table.data_ptr(),
                                    table.numel(), len(OFFSETS), plan.band_rows, b, N, tile, smem,
                                    stream)
        assert rc == 0, rc

    def dw(lib, setting, v, g, out):
        b = v.shape[0]
        tile = tile_of(setting, b)
        smem = stage(b, tile, b, 0) + 4 * table.numel()
        rc = lib.stencil_dw_f32(v.data_ptr(), g.data_ptr(), out.data_ptr(), table.data_ptr(),
                                table.numel(), len(OFFSETS), b, N, tile, smem, stream)
        assert rc == 0, rc

    def rmv(lib, setting, v, out):
        b = v.shape[0]
        tile = tile_of(setting, b)
        smem = stage(b, tile, b + 1, plan_neg.band_rows) + 4 * table_neg.numel()
        rc = lib.gram_rmv_mask_f32(w_shift.data_ptr(), mask.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), table_neg.data_ptr(), table_neg.numel(),
                                   len(NEG), plan_neg.band_rows, b, N, tile, smem, stream)
        assert rc == 0, rc

    def epilogue(lib, setting, t, v, out, part):
        b = v.shape[0]
        tile = tile_of(setting, b)
        smem = stage(b, tile, b, plan.band_rows) + 4 * table.numel()
        assert part.shape == (b, -(-N // tile))
        rc = lib.gram_mv_epilogue_f32(w.data_ptr(), t.data_ptr(), mask.data_ptr(), v.data_ptr(),
                                      nv.data_ptr(), out.data_ptr(), part.data_ptr(),
                                      table.data_ptr(), table.numel(), len(OFFSETS),
                                      plan.band_rows, b, N, tile, smem, stream)
        assert rc == 0, rc

    for b in BATCHES:
        v, g = torch.randn(b, N, device=dev), torch.randn(b, N, device=dev)
        out, dwo, t, o2 = (torch.empty_like(v), torch.empty_like(w), torch.empty_like(v),
                           torch.empty_like(v))
        ref, ref_dw = k1.matvec_plain(w, v, OFFSETS), k1._dw_matvec(v, g, OFFSETS)
        ref_t = k2.rmv_mask_plain(w_shift, mask, v, NEG)
        ref_o, ref_dot = k2.mv_epilogue_plain(w, ref_t, mask, v, nv, OFFSETS)
        parts = {s: torch.empty(b, -(-N // tile_of(s, b)), device=dev) for s in SETTINGS}
        for lib, setting in zip(libs, SETTINGS):
            product(lib, setting, v, out)
            dw(lib, setting, v, g, dwo)
            rmv(lib, setting, v, t)
            epilogue(lib, setting, ref_t, v, o2, parts[setting])
            torch.cuda.synchronize()
            for got, want in ((out, ref), (dwo, ref_dw), (t, ref_t), (o2, ref_o)):
                assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
            dot = parts[setting].sum(dim=1)
            assert float(((dot - ref_dot).abs() / ref_dot.abs()).max()) <= 1e-5
        times = {s: [] for s in SETTINGS}
        for order in (SETTINGS, SETTINGS[::-1]):
            for s in order:
                lib = libs[SETTINGS.index(s)]
                times[s].append((ms(lambda: product(lib, s, v, out)),
                                 ms(lambda: dw(lib, s, v, g, dwo)),
                                 ms(lambda: rmv(lib, s, v, t)),
                                 ms(lambda: epilogue(lib, s, ref_t, v, o2, parts[s]))))
        bound = 4.0 * (len(OFFSETS) * N + 2 * b * N) / 3.35e12 * 1e3
        bound_a = 4.0 * (len(OFFSETS) * N + 2 * b * N + N) / 3.35e12 * 1e3
        bound_b = 4.0 * (len(OFFSETS) * N + 3 * b * N + N) / 3.35e12 * 1e3
        for (small, large, threads), t_s in times.items():
            row = lambda k: " / ".join(f"{x[k]:.4f}" for x in t_s)
            print(f"B={b} tile {small if _wide(b) else large} kThreads={threads}: K1 {row(0)} ms, "
                  f"dw {row(1)} ms (bound {bound:.4f} ms), K2a {row(2)} ms (bound {bound_a:.4f}), "
                  f"K2b {row(3)} ms (bound {bound_b:.4f})", flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
