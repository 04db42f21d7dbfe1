"""The port's first slice end to end against the JAX package.

``ArmadaSystem`` with 64 nodes and 256 users, a fluid ``ClientPool`` on
the host tick whose candidate refreshes go through geo_topk, volunteer
churn (``ChurnModel``) for six probe periods — the
``bench_client_scale --smoke`` shape — run once in ``repro`` (its jnp
oracle on the CPU) and once in ``repro_torch`` (the plain PyTorch
version on the CPU).  The decision streams must be identical: candidate
matrix, actives, pending switches, failovers, requests sent, the switch
records and per-user frame counts; frame latency sums agree to allclose.
Every refresh's (scores, indices) are recorded on both sides, so a
mismatch reports the score margin of the first differing decision.
"""
import importlib

import numpy as np
import pytest

from repro_torch.kernels.geo_topk import kernel

SERVICE = "detect"
METRO = (44.97, -93.22)


def _system(pkg: str, n_nodes: int, seed: int):
    """``bench_client_scale._system`` built from the given package."""
    am_mod = importlib.import_module(f"{pkg}.core.app_manager")
    beacon = importlib.import_module(f"{pkg}.core.beacon")
    cluster = importlib.import_module(f"{pkg}.core.cluster")
    rng = np.random.default_rng(seed)
    nets = ("wifi", "ethernet", "lte")
    nodes = {}
    for i in range(n_nodes):
        nodes[f"N{i}"] = cluster.NodeSpec(
            f"N{i}",
            (METRO[0] + float(rng.uniform(-0.5, 0.5)),
             METRO[1] + float(rng.uniform(-0.5, 0.5))),
            proc_ms=float(rng.uniform(10, 30)),
            slots=int(rng.integers(4, 17)),
            dedicated=bool(rng.random() < 0.2),
            net_type=nets[int(rng.integers(len(nets)))])
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    sys_ = beacon.ArmadaSystem(cluster.Topology(nodes, {}), seed=seed,
                               trace_enabled=False,
                               include_cloud_compute=False, **kw)
    sys_.am.services[SERVICE] = am_mod.ServiceSpec(SERVICE,
                                                   beacon.detection_image())
    sys_.am.tasks[SERVICE] = []
    sys_.am.users[SERVICE] = []
    for i, cap in enumerate(sys_.captains.values()):
        t = am_mod.Task(f"{SERVICE}/t{i}", SERVICE, captain=cap,
                        status="running", ready_at=0.0)
        cap.tasks[t.task_id] = t
        sys_.am.tasks[SERVICE].append(t)
    sys_.am.autoscale_enabled = False
    return sys_


def _run(pkg: str, n_users=256, n_nodes=64, n_ticks=6, seed=0,
         probe_period=2000.0):
    churn_mod = importlib.import_module(f"{pkg}.core.churn")
    sys_ = _system(pkg, n_nodes, seed)
    rng = np.random.default_rng(seed + 1)
    locs = np.stack([METRO[0] + rng.uniform(-0.5, 0.5, n_users),
                     METRO[1] + rng.uniform(-0.5, 0.5, n_users)], axis=1)
    eng = sys_.am.engine
    refreshes = []
    inner = eng.candidate_indices_device

    def recording(*a, **kw):
        res = inner(*a, **kw)
        if res is not None:
            refreshes.append(tuple(np.asarray(x) for x in res))
        return res

    eng.candidate_indices_device = recording
    pool = sys_.make_client_pool(
        SERVICE, locs=locs, nets="wifi", transport="fluid",
        probe_period_ms=probe_period, frame_interval_ms=1000.0,
        selection_backend="geo_topk", tick="host", record_samples=False)
    sys_.sim.at(0.0, pool.start)
    churn = churn_mod.ChurnModel(sys_.sim, sys_.captains,
                                 volunteer_mttf_ms=40 * probe_period,
                                 mttr_ms=5 * probe_period)
    churn.start()
    sys_.sim.run(until=n_ticks * probe_period)
    assert not sys_.sim.truncated
    return pool, churn, refreshes


def _first_margin(jref, tref):
    """Describe the first refresh whose indices differ: the user, column
    and the JAX side's score gap to the neighbouring rank there."""
    for r, ((js, ji), (ts, ti)) in enumerate(zip(jref, tref)):
        if ji.shape != ti.shape or (ji != ti).any():
            u, c = map(int, np.argwhere(ji != ti)[0])
            row = js[u]
            gaps = [abs(row[c] - row[c + d]) for d in (-1, 1)
                    if 0 <= c + d < row.size]
            return (f"refresh {r}, user {u}, rank {c}: jax {ji[u].tolist()}"
                    f" vs torch {ti[u].tolist()}, score margin "
                    f"{min(gaps) if gaps else float('nan'):.3e}")
    return "no differing refresh (the streams diverged elsewhere)"


@pytest.fixture(scope="module")
def runs():
    kernel.reset_launches()
    jax_run = _run("repro")
    torch_run = _run("repro_torch")
    launches = dict(kernel.LAUNCHES)
    return jax_run, torch_run, launches


def test_slice_runs_under_churn_through_geo_topk(runs):
    (jpool, jchurn, jref), (tpool, tchurn, tref), launches = runs
    assert tpool.ticks_run >= 4
    assert len(tref) >= tpool.ticks_run           # initial + every tick
    assert sum(1 for e in tchurn.events if e["kind"] == "leave") > 0
    assert tpool.failovers > 0
    # the CPU run takes the plain version: no kernel launched
    assert all(v == 0 for v in launches.values()), launches


def test_slice_refreshes_identical(runs):
    (_, _, jref), (_, _, tref), _ = runs
    assert len(jref) == len(tref)
    for (js, ji), (ts, ti) in zip(jref, tref):
        assert np.array_equal(ji, ti), _first_margin(jref, tref)
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("field", ["cand_task", "active", "pending",
                                   "frame_count"])
def test_slice_state_identical(runs, field):
    (jpool, _, jref), (tpool, _, tref), _ = runs
    assert np.array_equal(getattr(jpool, field), getattr(tpool, field)), \
        _first_margin(jref, tref)


def test_slice_counters_and_switch_stream_identical(runs):
    (jpool, jchurn, jref), (tpool, tchurn, tref), _ = runs
    why = _first_margin(jref, tref)
    assert jchurn.events == tchurn.events
    assert (jpool.ticks_run, jpool.failovers, jpool.requests_sent) == \
        (tpool.ticks_run, tpool.failovers, tpool.requests_sent), why
    want = list(zip(jpool.switch_t, jpool.switch_user, jpool.switch_from,
                    jpool.switch_to))
    got = list(zip(tpool.switch_t, tpool.switch_user, tpool.switch_from,
                   tpool.switch_to))
    assert got == want, why
    assert len(got) > 0


def test_slice_latency_aggregates_close(runs):
    (jpool, _, _), (tpool, _, _), _ = runs
    np.testing.assert_allclose(tpool.frame_sum, jpool.frame_sum,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tpool.mean_latency(), jpool.mean_latency(),
                               rtol=1e-9)
