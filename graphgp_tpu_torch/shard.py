"""Multi-device work over ``torch.distributed``: process groups, sharded
walks, sharded features, the distributed Gram solve and HMC chain slices.

Counterpart of ``graphgp_tpu/shard.py``. Where the JAX package maps one
program over a device mesh, here each device is a process (a rank) of a
process group: NCCL with one card a rank, or gloo on the CPU. A "mesh" is
the small :class:`Mesh` record of that group, this rank and its device.

* **Walks** split over start-node blocks: each rank walks its block against
  the whole (replicated) graph. The walk hash keys on global node ids, so the
  gathered log equals the single-device log bit for bit.
* **Features** split over the node axis: a rank holds a row block of Φ.
  :func:`sharded_features` wraps that block in :class:`ShardedFeatures`,
  whose products are the global ones, so ``gp.iterative``'s ``mll_cg``,
  ``fit`` and ``pathwise_predict`` run over it unchanged on every rank, as
  the JAX package's run over its sharded placement.
* **The Gram solve** is CG with replicated scalars and exactly two
  all-reduces a matvec, of the (Nt, B) partial Φᵀv and of the (n_train, B)
  partial K v; everything else is rank-local.
* **HMC chains** split over ranks; they need no collective until the end.

:func:`run_ranks` starts one process a rank, with a rendezvous through a file
store in a temporary directory (no port is opened).
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .devices import resolve_device
from .features import (DenseFeatures, EllFeatures, EllStepMatrices, LogFeatures, _f32,
                       with_transpose)
from .walker import WalkConfig, WalkLog, sample_walk_log

# Collectives made by this module (distributed_gram_solve: two all-reduces
# a matvec; ShardedFeatures: see its docstring); tests and chip_smoke read them.
all_reduces = 0
all_gathers = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a process group laid out along one named axis."""

    group: Any  # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device
    axis_name: str = "nodes"


def init_process_group(rank: int, world_size: int, store_path: str, device="cuda") -> None:
    """Join a process group through the file ``store_path`` (one rank a
    device): NCCL for a CUDA device, which becomes this process's card
    ``cuda:<rank>``, gloo for the CPU (``device="cpu"``). Raises without a
    card unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store_path}", rank=rank,
                            world_size=world_size)


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "nodes") -> Mesh:
    """The mesh of the initialized default process group, one device a rank.
    ``num_devices`` must equal its world size: launch that many ranks
    (:func:`run_ranks`) to run on that many devices."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call shard.init_process_group in every rank "
                           "(or start the ranks with shard.run_ranks) before make_mesh")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices needs {num_devices} ranks; "
                         f"this process group has {world}")
    nccl = dist.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh(group=None, rank=dist.get_rank(), size=world, device=device, axis_name=axis_name)


def _pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    global all_reduces
    all_reduces += 1
    dist.all_reduce(t, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's equally shaped ``t`` concatenated along ``dim``, in rank
    order, on every rank."""
    global all_gathers
    all_gathers += 1
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def sharded_walk_log(
    graph, seed: int, cfg: WalkConfig, mesh: Mesh, *, gather: bool = True
) -> WalkLog:
    """Walk all nodes with start-node blocks split over the mesh's ranks.

    Rank r walks the block ``[r·B, min((r+1)·B, N))`` with ``B = ⌈N / size⌉``;
    a short tail block walks only its real rows. With ``gather`` every rank
    returns the whole (L, N, W) log, equal to ``sample_walk_log``'s bit for
    bit; without, its own block's rows."""
    n = graph.num_nodes
    block = -(-n // mesh.size)
    lo = min(mesh.rank * block, n)
    hi = min(lo + block, n)
    log = sample_walk_log(graph.to(mesh.device), seed, cfg, node_offset=lo, num_start_nodes=hi - lo)
    if not gather:
        return log
    pad = block - (hi - lo)
    curs, loads = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in log)
    return WalkLog(all_gather_rows(curs, mesh, dim=1)[:, :n],
                   all_gather_rows(loads, mesh, dim=1)[:, :n])


def replicate(tree, mesh: Mesh):
    """Every tensor of a (nested dict / list / tuple) tree, and every object
    with a ``to`` (graphs, features), on the mesh's device: each rank holds
    the whole of it."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(replicate(v, mesh) for v in tree)
    if isinstance(tree, WalkLog):
        return WalkLog(*(t.to(mesh.device) for t in tree))
    if hasattr(tree, "to"):
        return tree.to(mesh.device)
    return tree


def shard_features(feats, mesh: Mesh):
    """This rank's row block of a Dense / ELL / Log features object (node
    axis 1 of its step matrices or log), on the mesh's device: a plain
    features object of ``N / size`` nodes. The node count must be a multiple
    of the world size (:func:`pad_features`). An ELL with its transpose gets
    the block's own, built on the mesh's device. For the global operator
    that ``gp.iterative`` trains on, see :func:`sharded_features`."""
    n = feats.num_nodes
    if n % mesh.size:
        raise ValueError(f"{n} nodes do not split over {mesh.size} ranks; pad_features first")
    b = n // mesh.size
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    block = lambda t: t[:, rows].to(mesh.device)
    if isinstance(feats, DenseFeatures):
        return DenseFeatures(block(feats.step_matrices))
    if isinstance(feats, EllFeatures):
        m = feats.mats
        local = EllFeatures(EllStepMatrices(block(m.cols), block(m.vals), m.num_target_nodes))
        return local if feats.csc is None else with_transpose(local)
    if isinstance(feats, LogFeatures):
        return LogFeatures(WalkLog(block(feats.log.curs), block(feats.log.loads)),
                           feats.num_target_nodes)
    raise TypeError(f"unsupported features type {type(feats)!r}")


def pad_features(feats, n_pad: int):
    """Zero-pad a features object's node axis (axis 1) up to ``n_pad`` rows.
    Padded rows are zero rows of Φ (zero step-matrix rows, zero loads), so
    they add nothing to any product: the padding is exact."""
    n = feats.num_nodes
    if n_pad == n:
        return feats
    if n_pad < n:
        raise ValueError(f"n_pad ({n_pad}) < num_nodes ({n})")
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, n_pad - n))
    if isinstance(feats, DenseFeatures):
        return DenseFeatures(pad(feats.step_matrices))
    if isinstance(feats, EllFeatures):
        # the transpose's entries name their source rows: padding leaves it valid
        m = feats.mats
        return EllFeatures(EllStepMatrices(pad(m.cols), pad(m.vals), m.num_target_nodes),
                           feats.csc)
    if isinstance(feats, LogFeatures):
        return LogFeatures(WalkLog(pad(feats.log.curs), pad(feats.log.loads)),
                           feats.num_target_nodes)
    raise TypeError(f"unsupported features type {type(feats)!r}")


# ---------------------------------------------------------------------------
# Features split over the ranks behind the global object's surface
# ---------------------------------------------------------------------------
#
# The collectives below are autograd Functions in conjugate pairs. Every
# rank's loss is the same replicated value, so:
#   * a sum over the ranks' partials (all-reduce) passes the cotangent on
#     unchanged to each partial;
#   * a replicated tensor that enters rank-local work (the modulator, a
#     replicated vector) gets a partial cotangent on each rank, which the
#     conjugate pair sums: identity forward, all-reduce backward;
#   * rows gathered from the ranks (all-gather) hand each rank its own rows
#     of the cotangent, and rows taken from a replicated tensor gather the
#     ranks' cotangents back.
# A replicated value that meets no block (the noise) is neither summed nor
# split: its gradient is computed alike on every rank.


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, mesh):
        return _all_reduce(part.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh), None


class _GatherColumns(torch.autograd.Function):
    """(B, block) on each rank → (B, size·block) on every rank."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.block = mesh, t.shape[1]
        return all_gather_rows(t, mesh, dim=1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.block
        return g[:, lo:lo + ctx.block], None


class _OwnColumns(torch.autograd.Function):
    """Replicated (B, size·block) → this rank's (B, block) columns."""

    @staticmethod
    def forward(ctx, v, mesh, block):
        ctx.mesh = mesh
        lo = mesh.rank * block
        return v[:, lo:lo + block].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g.contiguous(), ctx.mesh, dim=1), None, None


@dataclasses.dataclass(frozen=True)
class ShardedFeatures:
    """A Dense / ELL / Log features object with its node axis split over the
    ranks, behind the global object's surface: this rank's row block
    ``local`` (``N`` padded to a multiple of the world size, zero rows), the
    mesh, and the global node count.

    Products are the global ones, replicated on every rank:

    * ``rmatvec_bm(f, V)``: this rank's columns of V times the block,
      ``V_blk Φ_blk``, all-reduced to the (B, Nt) ``V Φ``;
    * ``matvec_bm(f, U)``: the block's rows ``U Φ_blkᵀ``, all-gathered to the
      (B, N) ``U Φᵀ``;
    * ``rows(f, idx)``: the rows of ``idx`` in the block, all-reduced.

    One all-reduce and one all-gather a Gram matvec ``Φ (Φᵀ v)`` forward; its
    backward for the modulator adds one all-reduce of the (B, Nt) cotangent
    and one of the modulator's partial gradient a product. Every branch of
    the solvers reads replicated values only (CG's residuals, Lanczos'
    coefficients, ``fit``'s solver space), so every rank makes the same
    collectives in the same order, in the adjoint solves too; draws must be
    the same on every rank (one seeded generator, or explicit probes / ε).

    ``gp.iterative``'s compact and full-node-space solvers both run over it.
    Its prediction solve is ``batched_cg`` on the full-space operator: the
    fused masked-Gram CG (kernel K2) serves ``ContractedStencil`` only, and a
    stencil layout is not split over ranks (nor in the JAX package).
    """

    local: Any
    mesh: Mesh
    num_nodes: int

    @property
    def num_target_nodes(self) -> int:
        return self.local.num_target_nodes

    @property
    def max_walk_length(self) -> int:
        return self.local.max_walk_length

    @property
    def block(self) -> int:
        return self.local.num_nodes

    def _f(self, f) -> torch.Tensor:
        return _Replicated.apply(_f32(f, self.mesh.device), self.mesh)

    def rmatvec_bm(self, f, v):
        """``V @ Φ``: (B, N) → (B, Nt)."""
        v = torch.nn.functional.pad(v, (0, self.block * self.mesh.size - self.num_nodes))
        part = self.local.rmatvec_bm(self._f(f), _OwnColumns.apply(v, self.mesh, self.block))
        return _SumOverRanks.apply(part, self.mesh)

    def matvec_bm(self, f, u):
        """``U @ Φᵀ``: (B, Nt) → (B, N)."""
        rows = self.local.matvec_bm(self._f(f), _Replicated.apply(u, self.mesh))
        return _GatherColumns.apply(rows, self.mesh)[:, :self.num_nodes]

    def rows(self, f, idx):
        """Dense ``Φ[idx, :]`` (R, Nt)."""
        idx = torch.as_tensor(idx, device=self.mesh.device).to(torch.int64)
        lo = self.mesh.rank * self.block
        mine = (idx >= lo) & (idx < lo + self.block)
        part = self.local.rows(self._f(f), torch.where(mine, idx - lo, 0)) * mine[:, None]
        return _SumOverRanks.apply(part, self.mesh)


def sharded_features(feats, mesh: Mesh) -> ShardedFeatures:
    """The global Dense / ELL / Log features object ``feats`` split over the
    mesh's ranks (padded to a multiple of the world size first): this rank
    keeps its row block on the mesh's device. Every rank calls it with the
    same ``feats``."""
    n = feats.num_nodes
    local = shard_features(pad_features(feats, _pad_to_multiple(n, mesh.size)), mesh)
    return ShardedFeatures(local, mesh, n)


def distributed_gram_solve(
    feats,
    params,
    train_idx: torch.Tensor,
    b: torch.Tensor,
    mesh: Mesh,
    kind: str = "free",
    *,
    tol: float = 1e-4,
    max_iters: int = 200,
) -> torch.Tensor:
    """Solve ``(K_tt + σ²I) x = b`` with the features split over the ranks.

    Each CG matvec is

        u   = all_reduce( Φ_blockᵀ scatter_local(v) )     # (Nt, B)
        K v = all_reduce( scatter_train( Φ_block u ) )    # (n_train, B)

    exactly two all-reduces (counted in ``all_reduces``); the CG scalars are
    computed from replicated values on every rank, so every rank takes the
    same steps. ``feats`` is the global Dense / ELL / Log object (this
    function pads and splits it); ``b`` is (n_train,) or column-major
    (n_train, B). Returns x in b's shape on every rank.
    """
    from .gp import params as gp_params
    from .linalg import batched_cg

    dev = mesh.device
    n = _pad_to_multiple(feats.num_nodes, mesh.size)
    local = shard_features(pad_features(feats, n), mesh)
    block = n // mesh.size
    offset = mesh.rank * block
    params = {k: v.to(dev) for k, v in params.items()}
    train_idx = torch.as_tensor(train_idx).to(device=dev, dtype=torch.int64)
    b = b.to(dev)
    f = gp_params.modulator(kind, params, feats.max_walk_length)
    noise = gp_params.noise_variance(params)
    in_block = (train_idx >= offset) & (train_idx < offset + block)
    mine = torch.nonzero(in_block)[:, 0]  # this rank's train slots
    local_rows = train_idx[mine] - offset

    def matvec(v):
        local_v = torch.zeros((block, v.shape[1]), dtype=v.dtype, device=dev).index_add(
            0, local_rows, v[mine])
        u = _all_reduce(local.rmatvec(f, local_v), mesh)
        out = v.new_zeros(v.shape)  # contiguous, as the collective needs
        out[mine] = local.matvec(f, u)[local_rows]
        return _all_reduce(out, mesh) + noise * v

    # plain CG, column-major, as the JAX package's
    return batched_cg(lambda _, v: matvec(v), None, b, tol=tol, max_iters=max_iters,
                      batch_axis=1).x


def sharded_hmc_chains(mesh: Mesh, num_chains: int) -> slice:
    """This rank's block of HMC chains: ``num_chains`` padded up to a multiple
    of the world size, one contiguous block a rank (``gp.hmc.sample``)."""
    per = -(-num_chains // mesh.size)
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


# ---------------------------------------------------------------------------
# The multi-chip dryrun
# ---------------------------------------------------------------------------


def _ring_adjacency(n: int):
    import numpy as np

    adj = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = 1.0
    adj[(idx + 1) % n, idx] = 1.0
    return adj


def _standard_normal_log_prob(p):
    return -0.5 * (p["beta"] * p["beta"]).sum()


def dryrun_multichip(mesh: Mesh, probes: Optional[torch.Tensor] = None) -> dict:
    """One full sharded training step on tiny shapes, on every rank of the
    mesh (run it with :func:`run_ranks`): the JAX package's
    ``__graft_entry__.dryrun_multichip`` over ``torch.distributed``. On a
    ring of 16 nodes a rank:

    1. the sharded walk (wpn 8, p_halt 0.2, L 3), split as
       :class:`ShardedFeatures` over the log;
    2. the CG marginal likelihood's gradient over it (every second node
       trains, diffusion kind, 4 probes, CG tol 1e-3 and 30 iterations, 8
       Lanczos steps) and one Adam step (lr 0.05);
    3. pathwise posterior samples (4) at the odd nodes under the same split;
    4. ``distributed_gram_solve`` of ``cos(0.2 i)`` (tol 1e-3, 30 iterations);
    5. HMC chains over the ranks (one a rank; 10 warmup, 20 samples, 4
       leapfrog steps) on a standard normal.

    ``probes`` (4, n_train) replace the probes drawn from a generator seeded
    2, so a test can hand in the JAX run's. Returns the loss before the
    step, the solve's norm and the mean acceptance, which rank 0 prints as
    the JAX function does."""
    from .gp import hmc, iterative
    from .gp import params as P
    from .graphs import pack_laplacian

    dev = mesh.device
    n = 16 * mesh.size
    graph = pack_laplacian(_ring_adjacency(n))
    cfg = WalkConfig(walks_per_node=8, p_halt=0.2, max_walk_length=3)

    # 1. the sharded walk: start-node blocks over the ranks, bit-identical
    log = sharded_walk_log(graph, 0, cfg, mesh)
    feats = sharded_features(LogFeatures(log, num_target_nodes=n), mesh)

    # 2. the sharded training step: CG marginal likelihood, its gradient, Adam
    train_idx = torch.arange(0, n, 2, device=dev)
    y = torch.sin(torch.arange(train_idx.shape[0], dtype=torch.float32, device=dev) * 0.3)
    params = {k: v.requires_grad_(True) for k, v in
              P.init_params("diffusion", cfg.max_walk_length, device=dev).items()}
    opt = torch.optim.Adam(list(params.values()), lr=0.05)
    settings = iterative.CGSettings(cg_tol=1e-3, cg_max_iters=30, num_probes=4,
                                    num_lanczos_iters=8)
    loss = -iterative.mll_cg(
        feats, params, train_idx, y, kind="diffusion", settings=settings,
        probes=None if probes is None else probes.to(dev),
        generator=torch.Generator(device=dev).manual_seed(2))
    loss.backward()
    opt.step()
    params = {k: v.detach() for k, v in params.items()}
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"dryrun_multichip: loss {float(loss)}")

    # 3. pathwise posterior sampling under the same split
    samples = iterative.pathwise_predict(
        feats, params, train_idx, y, torch.arange(1, n, 2, device=dev), kind="diffusion",
        num_samples=4, settings=settings, generator=torch.Generator(device=dev).manual_seed(3))
    if not bool(torch.isfinite(samples).all()):
        raise RuntimeError("dryrun_multichip: pathwise samples not finite")

    # 4. the explicit-collectives Gram solve (two all-reduces a CG iteration)
    b = torch.cos(torch.arange(train_idx.shape[0], dtype=torch.float32) * 0.2)
    x = distributed_gram_solve(LogFeatures(log, num_target_nodes=n), params, train_idx, b,
                               mesh, kind="diffusion", tol=1e-3, max_iters=30)
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError("dryrun_multichip: Gram solve not finite")

    # 5. HMC chains over the ranks
    res = hmc.sample(_standard_normal_log_prob, {"beta": torch.zeros(2, device=dev)},
                     torch.Generator().manual_seed(4),
                     config=hmc.HMCConfig(num_warmup=10, num_samples=20, num_leapfrog=4),
                     num_chains=mesh.size, mesh=dataclasses.replace(mesh, axis_name="chains"))
    if not bool(torch.isfinite(res.log_probs).all()):
        raise RuntimeError("dryrun_multichip: HMC log probabilities not finite")
    out = {"loss": float(loss.detach()), "solve_norm": float(torch.linalg.vector_norm(x)),
           "hmc_accept": float(res.accept_rate.mean())}
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): loss={out['loss']:.4f} "
              f"solve_norm={out['solve_norm']:.4f} hmc_accept={out['hmc_accept']:.2f} ok",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def _rank_entry(job_dir: str, rank: int) -> None:
    """A rank's process: join the group, run the job's function on the mesh,
    save what it returns."""
    with open(os.path.join(job_dir, "job.pkl"), "rb") as fh:
        job = pickle.load(fh)
    module, qualname = job["fn"]
    fn = importlib.import_module(module)
    for part in qualname.split("."):
        fn = getattr(fn, part)
    dev = torch.device(job["device"])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init_process_group(rank, job["world_size"], os.path.join(job_dir, "store"), dev)
    try:
        out = fn(make_mesh(job["world_size"], job["axis_name"]), *job["args"])
        torch.save(out, os.path.join(job_dir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args, device="cuda", axis_name: str = "nodes",
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes, one rank each,
    and return what each rank returned (moved to the CPU), in rank order.

    ``fn`` must be a module-level function (each rank imports it by name)
    and ``args`` picklable. The ranks meet through a file store in a
    temporary directory; on CUDA (the default; raises without a card) they
    use NCCL and the card ``cuda:<rank>``, with ``device="cpu"`` gloo and one
    thread each. A rank that fails, or a run longer than ``timeout`` seconds,
    stops every rank and raises with the failed rank's output.
    """
    device = resolve_device(device)
    module = fn.__module__
    if module == "__main__":  # a script run with -m: name its module
        module = getattr(sys.modules["__main__"].__spec__, "name", module)
    with tempfile.TemporaryDirectory() as job_dir:
        with open(os.path.join(job_dir, "job.pkl"), "wb") as fh:
            pickle.dump({"fn": (module, fn.__qualname__), "args": args, "world_size": world_size,
                         "device": str(device), "axis_name": axis_name}, fh)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        code = ("import sys; from graphgp_tpu_torch.shard import _rank_entry; "
                "_rank_entry(sys.argv[1], int(sys.argv[2]))")
        procs, logs = [], []
        for rank in range(world_size):
            log = open(os.path.join(job_dir, f"log{rank}.txt"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, "-c", code, job_dir, str(rank)],
                                          env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
                if time.monotonic() > deadline:
                    failed = -1
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
        for out in outputs:
            if out:
                print(out, end="", flush=True)
        if failed is not None:
            what = (f"timed out after {timeout} s" if failed < 0
                    else f"rank {failed} exited with {procs[failed].returncode}")
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, {world_size}): {what}")
        return [torch.load(os.path.join(job_dir, f"out{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world_size)]
