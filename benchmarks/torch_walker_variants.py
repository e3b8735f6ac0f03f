#!/usr/bin/env python3
"""Kernel K4 (fused walks -> dense step matrices) in several variants, on one
CUDA card.

Builds ``graphgp_tpu_torch/csrc/walker.cu`` once per setting below (one nvcc
each, all started together), each a copy of the source with a few lines
edited: the last step whose records the lanes of a warp sum among
themselves before their atomic (kAggSteps, 2 as shipped); and two settings
that time a part of the kernel by leaving the rest out (no records; plain,
racy adds in place of the global atomics). It prints the atomic
instructions of the shipped build (cuobjdump -sass). Each setting runs at
the shapes chip_smoke.py tables, at the block size the planner picks and at
256, 512 and 1024 threads. Every run of a full setting is held against the
plain version first (3e-5 of max |ref|, M[0] exactly I). Time: the device
time of the launch's kernels (table pack and walk, the mean of each over
REPS launches) from torch.profiler. The shipped setting is the first of the
list.

Usage, from the repository root: python3 benchmarks/torch_walker_variants.py
"""
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from graphgp_tpu_torch.cuda_kernels import _build  # noqa: E402
from graphgp_tpu_torch.cuda_kernels import walker as k4  # noqa: E402
from graphgp_tpu_torch.data import database, synthetic  # noqa: E402
from graphgp_tpu_torch.graphs import pack_dense, pack_laplacian  # noqa: E402
from graphgp_tpu_torch.walker import WalkConfig, key_words  # noqa: E402

REPS = 10
REL_TOL = 3e-5
RECORDS = "    if (l > 0) {\n      float* cell"
ADD_SUM = "if ((t & 31) == __ffs(peers) - 1) atomicAdd(cell, sum);"
ADD_ONE = "        atomicAdd(cell, load);"
AGG = "constexpr int kAggSteps = 2;"
SETTINGS = [  # (name, source edits, checked); the shipped source first
    ("shipped", [], True),
    ("no warp aggregation", [(AGG, "constexpr int kAggSteps = 0;")], True),
    ("aggregate step 1", [(AGG, "constexpr int kAggSteps = 1;")], True),
    ("aggregate steps 1-3", [(AGG, "constexpr int kAggSteps = 3;")], True),
    ("aggregate every step", [(AGG, "constexpr int kAggSteps = 1000000;")], True),
    ("timing only: no records", [(RECORDS, "    if (false) {\n      float* cell")], False),
    ("timing only: plain adds", [(ADD_SUM, "if ((t & 31) == __ffs(peers) - 1) *cell += sum;"),
                                 (ADD_ONE, "        *cell += load;")], False),
]
THREADS = (None, 256, 512, 1024)  # None: the planner's


def build(tmp):
    procs = []
    src = os.path.join(_build.CSRC, "walker.cu")
    source = open(src).read()
    for k, (name, edits, _) in enumerate(SETTINGS):
        body = source
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            body = body.replace(old, new)
        copy = os.path.join(tmp, f"walker_{k}.cu")
        with open(copy, "w") as fh:
            fh.write(body)
        out = os.path.join(tmp, f"walker_{k}.so")
        procs.append((name, out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, copy],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (name, out, proc), (_, _, checked) in zip(procs, SETTINGS):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs}, spill stores {spills}", flush=True)
        lib = ctypes.CDLL(out)
        p, i, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.walk_step_matrices_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, u32, u32, f32, f32,
                                               i, p]
        libs.append((name, lib, checked))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", procs[0][1]], capture_output=True, text=True)
    ops = {}
    for op in re.findall(r"\b((?:RED|REDG|ATOM|ATOMS|ATOMG|MATCH)\.[A-Z0-9.]+)", dump.stdout):
        ops[op] = ops.get(op, 0) + 1
    print(f"shipped build, atomic instructions in the SASS: {ops or dump.stderr.strip()}",
          flush=True)
    return libs


def device_ms(fn):
    """Device milliseconds of one call's kernels (table pack, walk): the mean
    duration of each over REPS calls, summed, by torch.profiler. Only a
    session that saw each kernel REPS times counts (a session now and then
    loses device events); NaN after five that did not."""
    names = ("walk_step_matrices", "pack_walk_table")
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us = {name: [] for name in names}
        for e in prof.events():
            for name in names:
                if e.device_type == DeviceType.CUDA and name in e.name:
                    us[name].append(e.time_range.elapsed_us())
        if all(len(v) == REPS for v in us.values()):
            return sum(sum(v) / REPS for v in us.values()) / 1e3
    return float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_walker_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp()
    libs = build(tmp)
    mesh = synthetic._grid_adjacency(30).toarray()
    pems = database._load_csr_npz("processed_data/pems_bay.npz")[0]
    big = synthetic.generate("grid", 4096, seed=0)["adjacency"]
    cases = [
        ("mesh 30x30, principled", pack_laplacian(mesh), WalkConfig(1000, 0.01, 10)),
        ("mesh 30x30, ad-hoc", pack_dense(mesh), WalkConfig(1000, 0.01, 10, ablation=True)),
        ("PEMS", pack_laplacian(pems), WalkConfig(1024, 0.1, 10)),
        ("PEMS", pack_laplacian(pems), WalkConfig(1, 0.1, 10)),
        ("grid 64x64", pack_laplacian(big), WalkConfig(8192, 0.1, 10)),
        ("grid 64x64", pack_laplacian(big), WalkConfig(64, 0.1, 10)),
        ("grid 64x64", pack_laplacian(big), WalkConfig(256, 0.1, 16)),
    ]
    for cname, graph, cfg in cases:
        graph = graph.to("cuda")
        n, d = graph.neighbors.shape
        w, steps = cfg.walks_per_node, cfg.max_walk_length
        ref = k4.sample_dense_step_matrices_plain(graph, 1, cfg)
        scale = float(ref.abs().max())
        eye = torch.eye(n, device="cuda")
        out = torch.empty((steps, n, n), device="cuda")
        table = torch.empty((n, d, 2), dtype=torch.int32, device="cuda")
        k0, k1 = key_words(1)
        planned = k4.block_threads(w, steps * n)
        print(f"{cname}: N={n} D={d} W={w} L={steps} p_halt={cfg.p_halt}", flush=True)
        for threads in THREADS:
            threads = threads or planned
            reads = []
            for name, lib, checked in libs:
                def run():
                    return lib.walk_step_matrices_f32(
                        graph.neighbors.data_ptr(), graph.weights.data_ptr(),
                        graph.degree.data_ptr(), table.data_ptr(), out.data_ptr(), n, d, w, steps,
                        int(cfg.ablation), k0, k1, ctypes.c_float(cfg.p_halt),
                        ctypes.c_float(1.0 / (1.0 - cfg.p_halt)), threads,
                        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                rc = run()
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
                rel = float((out - ref).abs().max()) / scale
                if checked and (rel > REL_TOL or not torch.equal(out[0], eye)):
                    raise AssertionError(f"{name} at {cname}: rel {rel}")
                reads.append(f"{name} {device_ms(run):.4f}")
            print(f"  {threads} threads{' (planned)' if threads == planned else ''}: "
                  + "; ".join(reads), flush=True)
        del ref, out, table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
