"""The port's ``SelectionEngine`` device path against the JAX package's.

Both packages build the same seeded metro fleet; the engine's
``candidate_indices_kernel`` (geo_topk on the engine's device — the plain
PyTorch version here on the CPU) must return exactly the JAX engine's
index matrix (its jnp oracle on the CPU) with hidden nodes, data
locality and the queueing term active, at several ``node_pad`` paddings
and list widths.  Also pinned here: the packaging rules (no import of
JAX or of the JAX package from ``repro_torch``), the device guard rails
and the launch counters staying at 0 on the CPU.
"""
import importlib
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels.geo_topk import kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVICE = "detect"


def _fleet(pkg: str, n_nodes=24, seed=0, spread=0.5, **kw):
    """Metro fleet with one running replica per node, built with the
    given package's own classes (``repro`` or ``repro_torch``)."""
    am_mod = importlib.import_module(f"{pkg}.core.app_manager")
    beacon = importlib.import_module(f"{pkg}.core.beacon")
    cluster = importlib.import_module(f"{pkg}.core.cluster")
    rng = np.random.default_rng(seed)
    nets = ("wifi", "ethernet", "lte")
    nodes = {f"N{i}": cluster.NodeSpec(
        f"N{i}", (44.97 + float(rng.uniform(-spread, spread)),
                  -93.22 + float(rng.uniform(-spread, spread))),
        proc_ms=float(rng.uniform(10, 30)),
        slots=int(rng.integers(2, 9)),
        dedicated=bool(rng.random() < 0.2),
        net_type=nets[int(rng.integers(len(nets)))])
        for i in range(n_nodes)}
    topo = cluster.Topology(nodes, {})
    if pkg == "repro_torch":
        kw.setdefault("device", "cpu")
    sys_ = beacon.ArmadaSystem(topo, seed=seed, trace_enabled=False,
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


def _users(n, seed):
    rng = np.random.default_rng(seed)
    locs = np.stack([44.97 + rng.uniform(-.5, .5, n),
                     -93.22 + rng.uniform(-.5, .5, n)], axis=1)
    return locs, rng.integers(0, 4, n)


def _stress(sys_):
    """Hidden nodes, a data-locality preference and a real queueing
    backlog on every third node — all dynamic inputs of the scorer."""
    eng = sys_.am.engine
    eng.set_beacon_routing(None, {"N3", "N8", "N15"})
    eng.set_data_locality(SERVICE, [(44.9, -93.3), (45.2, -93.0)])
    eng.set_queueing_awareness(SERVICE)
    for i, cap in enumerate(sys_.captains.values()):
        if i % 3 == 0:
            cap.arrive_batch(400.0, 1.0, 1_000.0, 0.0)


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert all(v == 0 for v in kernel.LAUNCHES.values()), kernel.LAUNCHES


# ---------------------------------------------------------------------------
# (c) the engine's kernel path against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("node_pad,top_n", [(256, 3), (32, 3), (16, 64),
                                            (8, 5)])
@pytest.mark.parametrize("stressed", [False, True])
def test_candidate_indices_kernel_matches_jax(node_pad, top_n, stressed):
    jsys = _fleet("repro", seed=3)
    tsys = _fleet("repro_torch", seed=3)
    if stressed:
        _stress(jsys)
        _stress(tsys)
    locs, nets = _users(40, seed=4)
    jt, tt = jsys.am.tasks[SERVICE], tsys.am.tasks[SERVICE]
    want = jsys.am.engine.candidate_indices_kernel(
        SERVICE, jt, locs, nets, top_n=top_n, node_pad=node_pad)
    got = tsys.am.engine.candidate_indices_kernel(
        SERVICE, tt, locs, nets, top_n=top_n, node_pad=node_pad)
    assert got.dtype == np.int32 and got.shape == (40, top_n)
    np.testing.assert_array_equal(got, want)
    # the port's numpy path ranks the same replicas
    np.testing.assert_array_equal(
        tsys.am.engine.candidate_indices(SERVICE, tt, locs, nets,
                                         top_n=top_n), got)
    if stressed:              # hidden nodes are never handed out
        hidden = {i for i, t in enumerate(tt)
                  if t.captain.node_id in ("N3", "N8", "N15")}
        assert not hidden & set(got.ravel().tolist())


def test_candidate_indices_device_returns_tensors_on_engine_device():
    jsys = _fleet("repro", seed=5)
    tsys = _fleet("repro_torch", seed=5)
    _stress(jsys)
    _stress(tsys)
    locs, nets = _users(30, seed=6)
    js, ji = jsys.am.engine.candidate_indices_device(
        SERVICE, jsys.am.tasks[SERVICE], locs, nets, top_n=6, node_pad=32)
    ts, ti = tsys.am.engine.candidate_indices_device(
        SERVICE, tsys.am.tasks[SERVICE], locs, nets, top_n=6, node_pad=32)
    assert ts.device.type == "cpu" and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)


def test_packed_static_matches_jax_padding():
    jsys = _fleet("repro", n_nodes=20, seed=1)
    tsys = _fleet("repro_torch", n_nodes=20, seed=1)
    jv = jsys.am.engine.service_view(SERVICE, jsys.am.tasks[SERVICE])
    tv = tsys.am.engine.service_view(SERVICE, tsys.am.tasks[SERVICE])
    jp = jv.packed_static(32)
    tp = tv.packed_static(32, "cpu")
    assert (tp.n, tp.n_pad) == (jp.n, jp.n_pad) == (20, 32)
    for fld in ("lat", "lon", "aff", "code20", "cloud"):
        np.testing.assert_array_equal(getattr(tp, fld).numpy(),
                                      np.asarray(getattr(jp, fld)), fld)
    assert tv.packed_static(32, "cpu") is tp          # cached per epoch
    mask, free = tv.dynamic_state()
    for a, b in zip(tv.padded_sched(mask, free, 32),
                    jv.padded_sched(*jv.dynamic_state(), 32)):
        np.testing.assert_array_equal(a, b)


def test_candidate_lists_kernel_matches_jax():
    jsys = _fleet("repro", seed=8)
    tsys = _fleet("repro_torch", seed=8)
    locs, _ = _users(12, seed=9)
    want = jsys.am.engine.candidate_lists_kernel(
        SERVICE, jsys.am.tasks[SERVICE], locs, "wifi", top_n=4)
    got = tsys.am.engine.candidate_lists_kernel(
        SERVICE, tsys.am.tasks[SERVICE], locs, "wifi", top_n=4)
    assert [[t.task_id for t in row] for row in got] == \
        [[t.task_id for t in row] for row in want]


# ---------------------------------------------------------------------------
# (e) the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print(len(mods), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.split(" ", 1)
    assert int(n_mods) >= 18
    assert bad.strip() == "[]", bad


def test_port_sources_have_no_jax_or_repro_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    pkg = pathlib.Path(repro_torch.__file__).parent
    files = sorted(pkg.rglob("*.py"))
    assert len(files) >= 20
    bad = [f"{p.relative_to(pkg)}:{i}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    assert {"repro_torch.core.beacon", "repro_torch.core.client_pool",
            "repro_torch.core.selection", "repro_torch.core.geohash",
            "repro_torch.kernels.geo_topk.kernel"} <= mods


# ---------------------------------------------------------------------------
# (f) device guard rails
# ---------------------------------------------------------------------------

def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core.selection import SelectionEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        SelectionEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        SelectionEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        _fleet("repro_torch", device="cuda")
    with pytest.raises(ValueError):
        SelectionEngine(device="meta")
    assert SelectionEngine(device="cpu").device == torch.device("cpu")


def test_unported_paths_raise_not_implemented():
    tsys = _fleet("repro_torch", n_nodes=8, seed=2)
    locs, _ = _users(4, seed=2)
    for kw in (dict(tick="device"), dict(mesh=2),
               dict(refresh_period_ms=2000.0, refresh_cap=16)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsys.make_client_pool(SERVICE, locs=locs, transport="fluid",
                                  frame_interval_ms=500.0,
                                  selection_backend="geo_topk", **kw)
    sharded = _fleet("repro_torch", n_nodes=8, seed=2, shard_precision=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sharded.am.engine.candidate_indices_kernel(
            SERVICE, sharded.am.tasks[SERVICE], locs, "wifi")
    # the numpy sharded path is ported as is
    assert sharded.am.engine.candidate_indices(
        SERVICE, sharded.am.tasks[SERVICE], locs, "wifi").shape == (4, 3)


def test_cpu_engine_never_launches_a_kernel():
    tsys = _fleet("repro_torch", seed=4)
    _stress(tsys)
    locs, nets = _users(20, seed=1)
    tsys.am.engine.candidate_indices_kernel(
        SERVICE, tsys.am.tasks[SERVICE], locs, nets, top_n=64)
    assert all(v == 0 for v in kernel.LAUNCHES.values())
