"""The loop-cost probes (K6-K10): the port's plain versions, reached
through the CPU wrappers of either layout, held to the JAX tool's own
Pallas kernels (tools/probe_loop_costs.py) run in interpret mode, also
with the walks live (the tool's walk start patched); deadcode's scratch
fill against the interpreter's; and the port's probe tool on the CPU.
The CUDA kernels themselves run only on a card (chip_smoke.py holds them
bit for bit to the plain versions there).

Tolerance rtol 1e-5 with NaN equal to NaN: XLA on the CPU does not keep
strict f32 operation order, so a strict f32 body/carried matches it bit for
bit at 2 trips and drifts by 1 ulp from 6 trips (relative 2e-7 at 40)."""
import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from twilight_tpu_torch.ops import probe_loop
from twilight_tpu_torch.tools import probe_loop_costs as port_tool

from conftest import REPO

torch.set_num_threads(1)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_loop_costs",
        os.path.join(REPO, "tools", "probe_loop_costs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _jax_tool()

# variant -> how the JAX tool's function is called
JAX_CALLS = {
    "carcass": ("carcass", ()),
    "body/carried": ("body", ("carried",)),
    "body/scratch": ("body", ("scratch",)),
    "scalar0d/cond": ("scalar0d", ("cond",)),
    "scalar0d/body": ("scalar0d", ("body",)),
    "scalar0d/both": ("scalar0d", ("both",)),
    "deadcode": ("deadcode", ()),
    "nested": ("nested", (False,)),
    "nested+walk": ("nested", (True,)),
}


def _jax_build(monkeypatch, name):
    """The tool's `build` for one variant, its pallas_call in interpret
    mode: `_delta` (and `_time`, which `nested` calls itself) is replaced
    to capture it instead of timing."""
    got = {}

    def fake_delta(build):
        got["build"] = build
        return 0.0

    def fake_time(fn):
        got.setdefault("build", sys._getframe(1).f_locals["build"])
        return 0.0

    monkeypatch.setattr(TOOL.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(TOOL, "_delta", fake_delta)
    monkeypatch.setattr(TOOL, "_time", fake_time)
    fn, args = JAX_CALLS[name]
    getattr(TOOL, fn)(*args)
    return got["build"]


def _check_against_jax_tool(monkeypatch, name, layout):
    """The plain version of `layout`'s kernel against the JAX tool's
    pallas_call at 2, 6 and 40 trips."""
    build = _jax_build(monkeypatch, name)
    got = {}
    for trips in (2, 6, 40):
        want = np.asarray(build(trips)())
        out = torch.empty((probe_loop.GRP, probe_loop.W),
                          dtype=torch.float32)
        got[trips] = probe_loop.run(name, trips, out, layout).numpy()
        assert want.shape == got[trips].shape == (8, 640)
        np.testing.assert_allclose(got[trips], want, rtol=1e-5, atol=0,
                                   equal_nan=True,
                                   err_msg=f"{name} at {trips} trips")
    if name == "body/scratch":
        assert np.isnan(got[6]).all()      # scratch read before written
    else:
        assert np.isfinite(got[6]).all()
    assert sum(fn.launches for fn in probe_loop.WRAPPERS) == 0


@pytest.mark.parametrize("name", list(JAX_CALLS))
def test_plain_version_matches_jax_tool(monkeypatch, capsys, name):
    """The plain version through the one-block layout's CPU wrapper."""
    _check_against_jax_tool(monkeypatch, name, "block")


@pytest.mark.parametrize("name", probe_loop.CLUSTER_VARIANTS)
def test_row_split_matches_jax_tool(monkeypatch, capsys, name):
    """The plain version through the cluster layout's CPU wrapper (the
    one plain version: the kernel splits the state by row, its plain
    version does not need to)."""
    _check_against_jax_tool(monkeypatch, name, "cluster")


LIVE = 4096        # a walk_floor above every row maximum at 2 trips


@pytest.mark.parametrize("name", probe_loop.WALK_VARIANTS)
def test_live_walks_match_jax_tool(monkeypatch, capsys, name):
    """With the walks live, the plain version steps them as the JAX
    tool's wstep does: the tool's walk start min(max(msp), -1) becomes
    min(max(msp), LIVE) (the one jnp.minimum of two 0-d int32 values in
    either program), its int8 scratch as the interpreter leaves it, at 2
    trips (the tool has no offset)."""
    import jax.numpy as jnp
    build = _jax_build(monkeypatch, name)
    minimum = jnp.minimum

    def live_start(a, b):
        if all(getattr(x, "shape", None) == ()
               and getattr(x, "dtype", None) == jnp.int32 for x in (a, b)):
            b = jnp.int32(LIVE)
        return minimum(a, b)
    monkeypatch.setattr(jnp, "minimum", live_start)
    want = np.asarray(build(2)())
    emits = []
    got = probe_loop.REFERENCES[name](2, "cpu", False, LIVE, emits).numpy()
    assert min(emits) > 0
    assert not np.array_equal(want, probe_loop.REFERENCES[name](2, "cpu")
                              .numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_tbs_fill_is_the_interpreters_uninitialised_int8():
    """deadcode's int8 scratch starts at the value the JAX interpreter
    gives uninitialised int8 scratch."""
    import jax.numpy as jnp
    from jax._src.pallas import primitives
    v = np.asarray(primitives.uninitialized_value((2,), jnp.int8))
    assert v.tolist() == [probe_loop.TBS_FILL] * 2


def test_loop_steps_and_wrapper_checks():
    assert [probe_loop.loop_steps(t) for t in (0, 1, 2, 3, 6, 40)] \
        == [0, 2, 2, 4, 6, 40]
    with pytest.raises(ValueError):
        probe_loop.body("carried", 2, torch.empty((8, 64)))
    with pytest.raises(ValueError):
        probe_loop.scalar0d("nope", 2, torch.empty((8, 640)))
    with pytest.raises(ValueError):
        probe_loop.run("nope", 2, torch.empty((8, 640)))
    # f32 -> int32 as XLA converts: saturating, NaN to 0
    x = torch.tensor([1.9, -1.9, 3e9, -3e9, float("nan"), float("inf")])
    assert probe_loop._to_int32(x).tolist() == [
        1, -1, 2 ** 31 - 1, -2 ** 31, 0, 2 ** 31 - 1]


B = " [one block]"
CARRIED = ["body/carried", "body/carried" + B]


CARCASS = ["carcass rows=8 cols=20", "carcass rows=8 cols=20" + B]


@pytest.mark.parametrize("what,lines", [
    ("carcass", CARCASS),
    ("body", CARRIED + ["body/scratch", "body/scratch" + B]),
    ("scalar0d", CARRIED + ["scalar0d/cond", "scalar0d/cond" + B,
                            "scalar0d/body", "scalar0d/body" + B,
                            "scalar0d/both", "scalar0d/both" + B]),
    ("deadcode", CARRIED + ["deadcode", "deadcode" + B]),
    ("nested", CARRIED + ["nested(2 tiles)", "nested(2 tiles)" + B,
                          "nested(2 tiles)+walk",
                          "nested(2 tiles)+walk" + B]),
    ("all", CARCASS + CARRIED
     + ["body/scratch", "body/scratch" + B] + CARRIED
     + ["scalar0d/cond", "scalar0d/cond" + B, "scalar0d/body",
        "scalar0d/body" + B, "scalar0d/both", "scalar0d/both" + B]),
])
def test_port_tool_argv_and_format(capsys, what, lines):
    """The port's tool takes the JAX tool's argv and prints one
    'label: X ns/step' line per variant, in the JAX tool's order, and for
    every variant a second line for the one-block instance (here on the
    CPU with the plain versions, at 2 and 4 trips)."""
    assert port_tool.main([what, "--device", "cpu", "--trips", "2",
                           "4"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("# device: cpu")
    labels = [ln.split(": ")[0] for ln in out[1:]]
    assert labels == lines
    for ln in out[1:]:
        value, unit = ln.split(": ")[1].split()
        float(value)
        assert unit == "ns/step"


def test_port_tool_refuses_a_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_tool.main(["carcass"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
