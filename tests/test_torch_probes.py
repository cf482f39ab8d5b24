"""The loop-cost probes (K6-K10): the port's plain versions (whole-state,
and for scalar0d and nested also row-split, the cluster kernels'
decomposition) held to the JAX tool's own Pallas kernels
(tools/probe_loop_costs.py) run in interpret mode, and the port's probe
tool on the CPU. The CUDA kernels themselves run only on a card
(chip_smoke.py holds them bit for bit to the plain versions there).

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
    """The whole-state plain version (the one-block kernel's)."""
    _check_against_jax_tool(monkeypatch, name, "block")


@pytest.mark.parametrize("name", probe_loop.CLUSTER_VARIANTS)
def test_row_split_matches_jax_tool(monkeypatch, capsys, name):
    """The row-split plain version (the cluster kernel's decomposition:
    each group row its own state)."""
    _check_against_jax_tool(monkeypatch, name, "cluster")


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


@pytest.mark.parametrize("what,lines", [
    ("carcass", ["carcass rows=8 cols=20"]),
    ("body", ["body/carried", "body/scratch"]),
    ("scalar0d", ["body/carried", "scalar0d/cond",
                  "scalar0d/cond [one block]", "scalar0d/body",
                  "scalar0d/body [one block]", "scalar0d/both",
                  "scalar0d/both [one block]"]),
    ("deadcode", ["body/carried", "deadcode"]),
    ("nested", ["body/carried", "nested(2 tiles)",
                "nested(2 tiles) [one block]", "nested(2 tiles)+walk",
                "nested(2 tiles)+walk [one block]"]),
    ("all", ["carcass rows=8 cols=20", "body/carried", "body/scratch",
             "body/carried", "scalar0d/cond", "scalar0d/cond [one block]",
             "scalar0d/body", "scalar0d/body [one block]", "scalar0d/both",
             "scalar0d/both [one block]"]),
])
def test_port_tool_argv_and_format(capsys, what, lines):
    """The port's tool takes the JAX tool's argv and prints one
    'label: X ns/step' line per variant, in the JAX tool's order, and for
    scalar0d's and nested's variants a second line for the one-block
    instance (here on the CPU with the plain versions, at 2 and 4
    trips)."""
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
