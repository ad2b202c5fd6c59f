"""The port's measured calibration (``runtime/calibrate.py``) against the
JAX package, on the reference's own calibration model
(``vgg_cifar(4, 8, 0.25)``, ``tests/test_runtime.py``'s ``cal_setup``) with
its weights and one AE drawn with numpy in the reference's tree.

Times are measurements, so no two runs agree on them; what both packages
must agree on is everything else.  Bars, fixed before measuring: the same
table keys, batch, meta and ``wire_bytes`` in every entry as the
reference's table (integers, equal); either package reads the other's JSON
to equal entries, and a table read back writes the same bytes; the
reference's ``test_measured_flow_uses_calibration`` and
``test_measured_flow_rescales_calibration_batch`` hold on both packages, and
one table priced by both gives equal flows (1e-12 relative; the same
arithmetic).
"""
import dataclasses
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.scenarios import Scenario as JScenario  # noqa: E402
from repro.core.split import SplitPlan as JPlan  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.netsim import simulator as JSIM  # noqa: E402
from repro.netsim.channel import Channel as JChannel  # noqa: E402
from repro_torch.core.scenarios import Scenario as TScenario  # noqa: E402
from repro_torch.core.split import SplitPlan as TPlan  # noqa: E402
from repro_torch.models import vgg as tvgg  # noqa: E402
from repro_torch.netsim import simulator as TSIM  # noqa: E402
from repro_torch.netsim.channel import Channel as TChannel  # noqa: E402
from repro_torch.params import ae_from_numpy, vgg_params_from_numpy  # noqa: E402
from repro_torch.runtime import calibrate as TCAL  # noqa: E402

# the module, which ``repro.runtime`` shadows with its ``calibrate`` function
JCAL = importlib.import_module("repro.runtime.calibrate")

INPUT_BYTES = 8 * 8 * 3 * 4
AE_AT = 1                        # the index in the split grid with an AE
PKGS = {"jax": (JCAL, JSIM, JScenario, JPlan, JChannel),
        "torch": (TCAL, TSIM, TScenario, TPlan, TChannel)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread in this module: its tensors are
    small, and the tier-1 run keeps six test processes busy on the host's
    cores at once, where an op's thread pool mostly waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Both packages' model, weights, grid and AE, and the reference's
    table: ``fused=True``, which measures the eager codec as well."""
    jm = jvgg.vgg_cifar(n_classes=4, input_hw=8, width_mult=0.25)
    tm = tvgg.vgg_cifar(n_classes=4, input_hw=8, width_mult=0.25)
    rng = np.random.default_rng(1)

    def draw(s):
        if len(s.shape) < 2:
            return np.zeros(s.shape, s.dtype)
        return (np.sqrt(2.0 / np.prod(s.shape[:-1])) * rng.standard_normal(s.shape)
                ).astype(s.dtype)
    p_np = jax.tree.map(draw, jax.eval_shape(jm.init, jax.random.PRNGKey(1)))
    splits = tm.cut_points()[:3]
    c = tm.activation_shapes(tm.init(0, device="cpu"), 1)[splits[AE_AT]][-1]
    ae_np = {"enc": {"w": (rng.standard_normal((c, c // 2)) / np.sqrt(c)).astype(np.float32),
                     "b": np.zeros(c // 2, np.float32)},
             "dec": {"w": (rng.standard_normal((c // 2, c)) / np.sqrt(c // 2)).astype(np.float32),
                     "b": np.zeros(c, np.float32)}}
    jp = jax.tree.map(jnp.asarray, p_np)
    jae = jax.tree.map(jnp.asarray, ae_np)
    tp = vgg_params_from_numpy(tm, p_np, device="cpu")
    tae = ae_from_numpy(ae_np, device="cpu")
    ref = JCAL.calibrate(jm, jp, splits, ae_map={splits[AE_AT]: jae}, batch=1, iters=1,
                         fused=True)
    return {"jm": jm, "jp": jp, "tm": tm, "tp": tp, "splits": splits,
            "tae": tae, "ref": ref}


@pytest.fixture(scope="module")
def port_tables(setup):
    """The port's tables over the same grid, eager and fused."""
    s = setup
    return {fused: TCAL.calibrate(s["tm"], s["tp"], s["splits"],
                                  ae_map={s["splits"][AE_AT]: s["tae"]}, batch=1, iters=1,
                                  fused=fused, device="cpu")
            for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True])
def test_table_has_the_reference_keys_and_wire_bytes(setup, port_tables, fused):
    ref, got = setup["ref"], port_tables[fused]
    assert sorted(got.entries) == sorted(ref.entries)
    assert (got.model_name, got.batch, got.splits()) == (ref.model_name, ref.batch,
                                                         ref.splits())
    assert got.meta == {**ref.meta, "fused": fused}
    for key, want in ref.entries.items():
        e = got.entries[key]
        assert e.wire_bytes == want.wire_bytes, key
        assert e.use_fused == (want.use_fused and fused), key
        times = [e.head_s, e.tail_s, e.encode_s, e.decode_s, e.fused_edge_s,
                 e.fused_server_s]
        assert all(math.isfinite(t) and t >= 0 for t in times), key
        if key.startswith("SC"):
            assert min(e.head_s, e.tail_s, e.encode_s, e.decode_s) > 0, key
            assert (min(e.fused_edge_s, e.fused_server_s) > 0) == fused, key
    # the ae8 cut ships fewer bytes than the int8 cut of the same activation
    sp = setup["splits"]
    assert ref.lookup("SC", sp[AE_AT]).wire_bytes < ref.lookup("SC", sp[AE_AT - 1]).wire_bytes
    assert got.lookup("RC").server_s == got.lookup("LC").edge_s > 0


def test_json_crosses_both_ways(setup, port_tables, tmp_path):
    ref, got = setup["ref"], port_tables[True]
    for src, reader in ((got, JCAL.CalibrationTable), (ref, TCAL.CalibrationTable)):
        path = tmp_path / f"{type(src).__module__}.json"
        src.to_json(str(path))
        back = reader.from_json(str(path))
        assert (back.model_name, back.batch, back.meta) == (src.model_name, src.batch, src.meta)
        assert {k: dataclasses.asdict(e) for k, e in back.entries.items()} == \
            {k: dataclasses.asdict(e) for k, e in src.entries.items()}
        again = tmp_path / "again.json"
        back.to_json(str(again))
        assert again.read_bytes() == path.read_bytes()


def _uses_calibration(pkg, model, params, splits, table):
    """The reference's ``test_measured_flow_uses_calibration`` on ``pkg``;
    returns the measured and the fallback flows."""
    cal, sim, scenario, plan, channel = PKGS[pkg]
    netcfg = sim.NetworkConfig("tcp", channel(1e-3, 100e6, 100e6, seed=0))
    sc = scenario("SC", plan(splits[1]))
    flow_a = sim.measure_flow(sc, netcfg, model, params, INPUT_BYTES)
    assert flow_a["cost_source"] == "analytic"
    with pytest.warns(DeprecationWarning, match="calibration="):
        flow_m = sim.measure_flow(sc, netcfg, model, params, INPUT_BYTES, calibration=table)
    e = table.lookup("SC", splits[1])
    assert flow_m["cost_source"] == "measured"
    assert flow_m["edge_s"] == pytest.approx(e.edge_s)
    assert flow_m["server_s"] == pytest.approx(e.server_s)
    assert flow_m["wire_bytes"] == e.wire_bytes
    assert len(flow_m["wire_s"]) == 8
    other = [c for c in model.cut_points() if c not in splits][0]
    with pytest.warns(DeprecationWarning):
        flow_f = sim.measure_flow(scenario("SC", plan(other)), netcfg, model, params,
                                  INPUT_BYTES, calibration=table)
    assert flow_f["cost_source"] == "analytic"
    return flow_a, flow_m, flow_f


def _same_flow(got, want):
    assert sorted(got) == sorted(want)
    for k in ("edge_s", "server_s", "wire_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
    for k in ("wire_bytes", "cost_source", "retries"):
        assert got[k] == want[k], k


def test_measured_flow_uses_calibration_on_both(setup, port_tables, tmp_path):
    s = setup
    _uses_calibration("jax", s["jm"], s["jp"], s["splits"], s["ref"])
    mine = _uses_calibration("torch", s["tm"], s["tp"], s["splits"], port_tables[True])
    # the port's table, read by the reference, prices the same flows there
    path = str(tmp_path / "port.json")
    port_tables[True].to_json(path)
    theirs = _uses_calibration("jax", s["jm"], s["jp"], s["splits"],
                               JCAL.CalibrationTable.from_json(path))
    for got, want in zip(mine, theirs):
        _same_flow(got, want)


def test_measured_flow_rescales_calibration_batch_on_both(setup, tmp_path):
    """A table calibrated at batch B serves batch-1 flows at 1/B cost, on
    both packages, from one table (the port's, read by the reference)."""
    s = setup
    table2 = TCAL.calibrate(s["tm"], s["tp"], s["splits"][:1], batch=2, iters=1,
                            device="cpu")
    path = str(tmp_path / "cal2.json")
    table2.to_json(path)
    flows = {}
    for pkg, table, model, params in (
            ("torch", table2, s["tm"], s["tp"]),
            ("jax", JCAL.CalibrationTable.from_json(path), s["jm"], s["jp"])):
        cal, sim, scenario, plan, channel = PKGS[pkg]
        e = table.lookup("SC", s["splits"][0])
        netcfg = sim.NetworkConfig("tcp", channel(1e-3, 100e6, 100e6, seed=0))
        sc = scenario("SC", plan(s["splits"][0]))
        flow1 = sim.measure_flow(sc, netcfg, model, params, INPUT_BYTES, cost=table, batch=1)
        assert flow1["edge_s"] == pytest.approx(e.edge_s / 2)
        assert flow1["server_s"] == pytest.approx(e.server_s / 2)
        assert flow1["wire_bytes"] == pytest.approx(e.wire_bytes / 2, abs=1)
        flow2 = sim.measure_flow(sc, netcfg, model, params, INPUT_BYTES, cost=table, batch=2)
        assert flow2["edge_s"] == pytest.approx(e.edge_s)
        assert flow2["wire_bytes"] == e.wire_bytes
        flows[pkg] = (flow1, flow2)
    for got, want in zip(flows["torch"], flows["jax"]):
        _same_flow(got, want)
    assert table2.batch == 2 and table2.lookup("RC").wire_bytes == 2 * INPUT_BYTES
