#!/usr/bin/env python3
"""Kernel K3 (ELL -> stencil) in several variants, on one CUDA card.

Builds ``graphgp_tpu_torch/csrc/stencil_build.cu`` once per setting below
(one nvcc each, all started together): the kernel as shipped; two builds
of the staged schedule as it would be without two of its choices (the
buffer 16 bytes into shared memory, not 32; the entry loop left to the
compiler's unrolling); and three settings that time a part of the staged
schedule by leaving the rest out (no write-out; copies only, no lookup or
add; a plain add in place of the shared-memory atomic). The builds other
than the shipped one run at the planner's schedule only; it prints the atomic
instructions in the shipped build's SASS (cuobjdump -sass). It times them at
the flagship's ELL (1000x1000 grid, walks_per_node 1000, p_halt 0.1, L 5;
S = 41), at that ELL cut to N = 999999 and R = 55 (N * R odd, so no bulk
copies), and at the scaling path's largest ring (N = 2^20, walks_per_node
100, L 3), over the narrow-row schedule and the staged one's tile widths,
the direct slot table against the binary search (lookup 0), and bulk copies
against 4-byte ones. Then, on synthetic ELLs of 2^20 nodes and 3 steps
(half the slots dead), the narrow-row schedule against the staged one for R
from 4 to 32, with 9 offsets that wrap round the graph (binary search) and
25 that do not (direct table): where the planner's NARROW_ROW_SLOTS comes
from. The kernel as shipped is held against the plain version first at
every plan (equal bit for bit). CUDA events around REPS launches after a
warm-up. The planner's schedule is the first of each list.

Usage, from the repository root: python3 benchmarks/torch_stencil_build_variants.py
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
from graphgp_tpu_torch.cuda_kernels import stencil_build as k3  # noqa: E402
from graphgp_tpu_torch.data import synthetic  # noqa: E402
from graphgp_tpu_torch.preprocessor import preprocess_graph  # noqa: E402
from graphgp_tpu_torch.walker import WalkConfig  # noqa: E402

REPS = 10
HBM_BYTES_PER_S = 3.35e12
WRITE = "          out[((long long)k.l * S + s) * N + k.i0 + j] = *cell;"
LOOP = "    for (int e = t; e < k.len; e += kThreads) {\n      const float x = s_vals[e];"
ADD = "if (pos >= 0) atomicAdd(&acc[pos * row + node], x);"
BUFFER = "int* s_cols = reinterpret_cast<int*>(smem + 32);"
BUFFER_BYTES = "return 32 + 8 * (size_t)chunk"
UNROLL = "#pragma unroll 1  // unrolled, the 4-byte copy build spilled and read 11% slower\n"
SETTINGS = [  # (name, nvcc defines, source edits, checked against the plain version)
    ("shipped", [], [], True),
    ("buffer 16 bytes in", [], [(BUFFER, BUFFER.replace("32", "16")),
                                (BUFFER_BYTES, BUFFER_BYTES.replace("32", "16"))], True),
    ("entry loop unrolled", [], [(UNROLL, "")], True),
    ("timing only: no write-out", [], [(WRITE, "          if (*cell == 1.5f) out[k.l] = *cell;")],
     False),
    ("timing only: copies, no lookup or add", [],
     [(LOOP, "    for (int e = t; e < 0 * k.len; e += kThreads) {\n      const float x = s_vals[e];")],
     False),
    ("timing only: plain add", [], [(ADD, "if (pos >= 0) acc[pos * row + node] += x;")], False),
]


def build(tmp):
    source = open(os.path.join(_build.CSRC, "stencil_build.cu")).read()
    procs = []
    for k, (name, defines, edits, _) in enumerate(SETTINGS):
        body = source
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            body = body.replace(old, new)
        src = os.path.join(tmp, f"stencil_build_{k}.cu")
        with open(src, "w") as fh:
            fh.write(body)
        out = os.path.join(tmp, f"stencil_build_{k}.so")
        procs.append((out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o",
                                             out, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
    libs = []
    for (name, _, _, checked), (out, proc) in zip(SETTINGS, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"{name}: ptxas " + "; ".join(line.strip() for line in log.splitlines()
                                           if "registers" in line), flush=True)
        lib = ctypes.CDLL(out)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ell_to_stencil_f32.argtypes = [p, p, p, p, i, ll, i, i, i, i, i, i, i, p]
        libs.append((name, lib, checked))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", procs[0][0]], capture_output=True, text=True)
    ops = {}
    for op in re.findall(r"\b((?:RED|REDG|ATOM|ATOMS|ATOMG)\.[A-Z0-9.]+)", dump.stdout):
        ops[op] = ops.get(op, 0) + 1
    print(f"shipped build, atomic instructions in the SASS: {ops or dump.stderr.strip()}",
          flush=True)
    return libs


def events_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def ell(kind, n, cfg):
    trace = {}
    feats = preprocess_graph(synthetic.generate(kind, n, seed=42)["adjacency"], cfg, seed=42,
                             cache_dir=None, layout="auto", device="cuda", trace=trace)
    mats = trace["ell"]
    return mats.cols, mats.vals, torch.from_numpy(feats.mats.offsets).to("cuda")


def synthetic_ell(n, r, s, wrap, seed=0):
    """(cols, vals, offsets) for 3 steps of n nodes: each row holds min(r, s)
    distinct vocabulary offsets, half the slots dead. ``wrap``: the offsets
    0, ±1, ... and their wrapped twins ±(n - k), as a ring's are."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if wrap:
        half = [k for k in range(1, (s - 1) // 4 + 1)]
        vocab = sorted([0] + half + [-k for k in half] + [n - k for k in half]
                       + [k - n for k in half])
    else:
        vocab = list(range(-(s // 2), s - s // 2))
    offs = torch.tensor(vocab, dtype=torch.int32, device="cuda")
    k = min(r, offs.numel())
    pick = torch.rand((3 * n, offs.numel()), generator=gen, device="cuda").argsort(dim=1)[:, :k]
    cols = torch.zeros((3 * n, r), dtype=torch.int64, device="cuda")
    cols[:, :k] = offs.long()[pick]
    nodes = torch.arange(n, device="cuda").repeat(3)[:, None]
    cols = (nodes + cols).to(torch.int32).reshape(3, n, r)
    vals = torch.randn((3, n, r), generator=gen, device="cuda")
    vals[:, :, k:] = 0.0
    vals[torch.rand((3, n, r), generator=gen, device="cuda") < 0.5] = 0.0
    return cols.contiguous(), vals.contiguous(), offs


def launcher(lib, name, cols, vals, offs, out, sched):
    l, n, r = cols.shape

    def run():
        rc = lib.ell_to_stencil_f32(
            cols.data_ptr(), vals.data_ptr(), offs.data_ptr(), out.data_ptr(), l, n, r,
            offs.numel(), int(sched.staged), sched.tile, sched.chunk, int(sched.bulk),
            sched.lookup, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{name} {sched}: CUDA error {rc}")
    return run


def describe(sched, s):
    if not sched.staged:
        return f"narrow rows, {sched.smem_bytes(s)} B"
    return (f"staged, tile {sched.tile}, chunk {sched.chunk}, "
            f"{'bulk' if sched.bulk else '4-byte'} copies, lookup {sched.lookup}, "
            f"{sched.smem_bytes(s)} B")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stencil_build_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build(tempfile.mkdtemp())
    cols, vals, offs = ell("grid", 1_000_000, WalkConfig(1000, 0.1, 5))
    cases = [("flagship", cols, vals, offs),
             ("flagship cut to N = 999999, R = 55", cols[:, :999_999, :55].contiguous(),
              vals[:, :999_999, :55].contiguous(), offs),
             ("ring 2^20", *ell("ring", 2**20, WalkConfig(100, 0.1, 3)))]
    del cols, vals
    for cname, cols, vals, offs in cases:
        l, n, r = cols.shape
        s = offs.numel()
        span = int(offs[-1] - offs[0]) + 1
        ref = k3.ell_to_stencil_plain(cols, vals, offs)
        out = torch.empty_like(ref)
        bound = (8.0 * l * n * r + 4.0 * l * s * n) / HBM_BYTES_PER_S * 1e3
        shipped = k3.plan(n, r, s, span)
        staged = k3.staged_plan(n, r, s, span)
        print(f"{cname}: L={l} N={n} R={r} S={s}, offsets span {span} columns, "
              f"{int((vals != 0).sum())} live entries; byte bound {bound:.4f} ms; plan {shipped}",
              flush=True)
        plans = [shipped]
        for tile in (32, 64, 128, 256, 512):
            chunk = min(tile * r, k3.STAGE_ENTRIES)
            cand = staged._replace(tile=tile, chunk=chunk, bulk=staged.bulk and chunk % 4 == 0)
            for sched in (cand, cand._replace(lookup=0), cand._replace(bulk=False),
                          k3.plan(n, r, s, span)._replace(staged=False)):
                if sched not in plans and sched.smem_bytes(s) <= k3.MAX_DYNAMIC_SMEM_BYTES:
                    plans.append(sched)
        for k, sched in enumerate(plans):
            reads = []
            for j, (name, lib, checked) in enumerate(libs):
                if j > 0 and (k > 0 or not sched.staged):  # other builds: the planner's schedule
                    continue
                run = launcher(lib, name, cols, vals, offs, out, sched)
                run()
                torch.cuda.synchronize()
                if checked and not torch.equal(out, ref):
                    raise AssertionError(f"{name} {sched} differs from the plain version")
                reads.append(f"{name} {events_ms(run):.4f}")
            print(f"  {describe(sched, s)}: " + "; ".join(reads), flush=True)
        del ref, out
        torch.cuda.empty_cache()
    name, lib, _ = libs[0]
    n = 2**20
    for wrap, s in ((True, 9), (False, 25)):
        for r in (4, 6, 8, 10, 12, 16, 24, 32):
            cols, vals, offs = synthetic_ell(n, r, s, wrap)
            span = int(offs[-1] - offs[0]) + 1
            ref = k3.ell_to_stencil_plain(cols, vals, offs)
            out = torch.empty_like(ref)
            bound = (8.0 * 3 * n * r + 4.0 * 3 * s * n) / HBM_BYTES_PER_S * 1e3
            reads = []
            for sched in (k3.plan(n, r, s, span)._replace(staged=False),
                          k3.staged_plan(n, r, s, span)):
                run = launcher(lib, name, cols, vals, offs, out, sched)
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{sched} differs from the plain version")
                reads.append(f"{describe(sched, s)} {events_ms(run):.4f}")
            print(f"synthetic N=2^20 L=3 R={r} S={s} ({'wrapping' if wrap else 'compact'} "
                  f"offsets, span {span}; byte bound {bound:.4f} ms; planner: "
                  f"{'staged' if k3.plan(n, r, s, span).staged else 'narrow rows'}): "
                  + "; ".join(reads), flush=True)
            del cols, vals, ref, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
