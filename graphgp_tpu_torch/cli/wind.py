"""Wind-field interpolation on a sphere-grid graph (ERA5/Aeolus protocol).

Counterpart of ``graphgp_tpu/cli/wind.py`` (the reference's
``wind_experiment.py``): a lat/lon sphere grid with longitude wraparound and
geodesic edge weights, training nodes restricted to a polar-orbit satellite
ground track, GRF kernels (free and diffusion) swept over walks_per_node,
Adam on the CG marginal likelihood, pathwise-conditioning prediction,
RMSE / NLPD per (seed, walks_per_node, kernel) into ``wind.csv``.

The ERA5 fields and the Aeolus orbit are not in the repository and nothing
is downloaded: ``--wind-npz`` reads the reference's processed npz when one is
given; otherwise a synthetic zonal-jet wind field on the grid stands in, and
the track is an analytic inclined great-circle sweep. Step matrices come from
``kernels.features_for_adjacency``: on the card, the fused walk kernel (K4).
Seeds follow the JAX CLI: walks from ``42 + seed``, the fit's draws from
``seed``, the prediction's from ``1000 + seed``.

Usage:
    python -m graphgp_tpu_torch.cli.wind --n-lat 19 --n-lon 36 --walks 128 512
    python -m graphgp_tpu_torch.cli.wind --device cpu --n-lat 7 --n-lon 12 --walks 50 --seeds 1
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import scipy.sparse as sp

from ..utils.config import add_config_flag, parse_with_config


def sph2cart(lat_deg, lon_deg):
    lat, lon = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], -1
    )


def great_circle_distance(lat1, lon1, lat2, lon2):
    """Haversine distance on the unit sphere; degrees in."""
    la1, lo1, la2, lo2 = map(np.deg2rad, (lat1, lon1, lat2, lon2))
    a = (
        np.sin((la2 - la1) / 2) ** 2
        + np.cos(la1) * np.cos(la2) * np.sin((lo2 - lo1) / 2) ** 2
    )
    return 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def build_sphere_grid_graph(lat, lon, connectivity=4):
    """4- or 8-neighbour lat/lon grid with longitude wraparound and geodesic
    edge weights, symmetrized. The nodes of a row at ±90° coincide, so their
    east–west weights are ~1e-17."""
    n_lat, n_lon = len(lat), len(lon)
    ii, jj = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    nid = (ii * n_lon + jj).ravel()
    nbrs = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if connectivity == 8:
        nbrs += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    rows, cols, data = [], [], []
    for di, dj in nbrs:
        ii2 = ii + di
        jj2 = (jj + dj) % n_lon
        valid = (ii2 >= 0) & (ii2 < n_lat)
        src = nid[valid.ravel()]
        ii2v, jj2v = ii2[valid], jj2[valid]
        dst = (ii2v * n_lon + jj2v).ravel()
        w = great_circle_distance(
            lat[ii[valid]], lon[jj[valid]], lat[ii2v], lon[jj2v]
        )
        rows.append(src)
        cols.append(dst)
        data.append(w)
    a = sp.coo_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_lat * n_lon, n_lat * n_lon),
    )
    return ((a + a.T) * 0.5).tocsr()


def synthetic_wind_speed(lat, lon, seed=0):
    """Zonal-jet wind magnitude: subtropical jets and planetary waves."""
    rng = np.random.default_rng(seed)
    lat_g, lon_g = np.meshgrid(lat, lon, indexing="ij")
    la, lo = np.deg2rad(lat_g), np.deg2rad(lon_g)
    jets = 30 * np.exp(-(((lat_g - 35) / 12) ** 2)) + 28 * np.exp(
        -(((lat_g + 40) / 14) ** 2)
    )
    waves = 6 * np.sin(3 * lo + 2 * la) + 4 * np.cos(5 * lo - la)
    return (jets + waves + rng.normal(0, 1.0, lat_g.shape)).ravel().astype(np.float32)


def orbit_track_from_coords(lat_g, lon_g, inclination=97.0, n_orbits=8, swath_deg=4.0):
    """Indices of the nodes, at per-node (lat, lon), under an inclined-orbit
    ground track (an analytic stand-in for propagating Aeolus' orbit)."""
    t = np.linspace(0, n_orbits * 2 * np.pi, n_orbits * 400)
    inc = np.deg2rad(inclination)
    track_lat = np.rad2deg(np.arcsin(np.sin(inc) * np.sin(t)))
    # the longitude drifts with the earth's rotation from orbit to orbit
    track_lon = (np.rad2deg(np.arctan2(np.cos(inc) * np.sin(t), np.cos(t)))
                 - (t / (2 * np.pi)) * (360.0 / n_orbits)) % 360.0 - 180.0
    d_lat = np.abs(lat_g[:, None] - track_lat[None, :])
    d_lon = np.abs(((lon_g[:, None] - track_lon[None, :] + 180) % 360) - 180)
    near = ((d_lat < swath_deg) & (d_lon < swath_deg)).any(axis=1)
    return np.flatnonzero(near).astype(np.int32)


def orbit_track_nodes(lat, lon, inclination=97.0, n_orbits=8, swath_deg=4.0):
    """:func:`orbit_track_from_coords` over the lat × lon grid's nodes."""
    lat_g = np.meshgrid(lat, lon, indexing="ij")[0].ravel()
    lon_g = np.meshgrid(lat, lon, indexing="ij")[1].ravel()
    return orbit_track_from_coords(
        lat_g, lon_g, inclination=inclination, n_orbits=n_orbits, swath_deg=swath_deg,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_flag(p)
    p.add_argument("--wind-npz", default=None,
                   help="reference processed wind npz (A_* triplets + X, y)")
    p.add_argument("--n-lat", type=int, default=19)
    p.add_argument("--n-lon", type=int, default=36)
    p.add_argument("--walks", type=int, nargs="+", default=[32, 128, 512])
    p.add_argument("--p-halt", type=float, default=0.1)
    p.add_argument("--max-walk-length", type=int, default=5)
    p.add_argument("--kinds", nargs="+", default=["free", "diffusion"])
    p.add_argument("--train-steps", type=int, default=300)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--num-pathwise-samples", type=int, default=200)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--results-dir", default="artifacts/results")
    return p


def load_wind_graph(args):
    """(adjacency, raw targets, sorted train-node track) from ``--wind-npz`` or
    the synthetic sphere grid."""
    if not args.wind_npz:
        lat = np.linspace(-90, 90, args.n_lat)
        lon = np.linspace(-180, 180, args.n_lon, endpoint=False)
        adj = build_sphere_grid_graph(lat, lon)
        return adj, synthetic_wind_speed(lat, lon), orbit_track_nodes(lat, lon)
    from ..data.database import _load_csr_npz

    adj, _, y_raw = _load_csr_npz(args.wind_npz)
    n = adj.shape[0]
    # The training set, in order of fidelity to the reference's npz schema:
    # the saved Aeolus-track node ids, else the orbit track through per-node
    # (lat, lon), else a random 30% (not the reference protocol).
    with np.load(args.wind_npz) as z:
        if "X_train" in z.files:
            track = np.sort(np.asarray(z["X_train"], np.int32))
            print("wind npz: using saved Aeolus-track training nodes")
        elif "coord_mapping" in z.files:
            coords = np.asarray(z["coord_mapping"], np.float64)
            track = orbit_track_from_coords(coords[:, 0], coords[:, 1])
            print("wind npz: orbit track derived from coord_mapping")
        else:
            rng = np.random.default_rng(0)
            track = np.sort(rng.choice(n, size=n // 3, replace=False)).astype(np.int32)
            print("wind npz: no track info; random 30% train split")
    return adj, y_raw, track


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    import torch

    from ..devices import resolve_device
    from ..gp import iterative
    from ..gp import params as P
    from ..kernels import features_for_adjacency
    from ..utils.io import print_summary, save_results

    dev = resolve_device(args.device)
    adj, y_raw, track = load_wind_graph(args)
    n = adj.shape[0]
    y_all = torch.from_numpy(
        ((y_raw - y_raw.mean()) / (y_raw.std() + 1e-12)).astype(np.float32)
    ).to(dev)
    test_nodes = np.setdiff1d(np.arange(n, dtype=np.int32), track)
    tr = torch.from_numpy(track.astype(np.int64)).to(dev)
    te = torch.from_numpy(test_nodes.astype(np.int64)).to(dev)
    print(f"sphere grid: {n} nodes; train (orbit track) {track.size}, test {test_nodes.size}")

    settings = iterative.CGSettings(cg_tol=1e-2, cg_max_iters=100, num_probes=16)
    records: List[Dict] = []
    for seed in range(args.seeds):
        for wpn in args.walks:
            feats = features_for_adjacency(
                adj, 42 + seed, walks_per_node=wpn, p_halt=args.p_halt,
                max_walk_length=args.max_walk_length, device=dev,
            )
            for kind in args.kinds:
                res = iterative.fit(
                    feats, tr, y_all[tr], kind=kind,
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    learning_rate=args.learning_rate, num_steps=args.train_steps,
                    settings=settings,
                )
                samples = iterative.pathwise_predict(
                    feats, res.params, tr, y_all[tr], te, kind=kind,
                    num_samples=args.num_pathwise_samples, settings=settings,
                    generator=torch.Generator(device=dev).manual_seed(1000 + seed),
                )
                summ = iterative.summarize_samples(samples)
                var = summ.var + P.noise_variance(res.params)
                rmse = float(torch.sqrt(torch.mean((summ.mean - y_all[te]) ** 2)))
                nlpd = float(torch.mean(
                    0.5 * (torch.log(2 * np.pi * var) + (y_all[te] - summ.mean) ** 2 / var)
                ))
                records.append({"seed": seed, "kernel": kind, "walks_per_node": wpn,
                                "rmse": rmse, "nlpd": nlpd})
                print(f"seed={seed} {kind} wpn={wpn}: rmse={rmse:.4f} nlpd={nlpd:.4f}")

    path = save_results(records, args.results_dir, "wind", config=vars(args))
    print_summary(records, ["kernel", "walks_per_node"], ["rmse", "nlpd"])
    print(f"results -> {path}")
    return records


if __name__ == "__main__":
    main()
