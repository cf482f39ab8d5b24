"""The cluster instances of the loop-cost probes K6 (carcass), K7 (body),
K8 (scalar0d), K9 (deadcode) and K10 (nested): one cluster of 8 CTAs,
CTA g holding group row g (ops/csrc/probe_loop_costs.cu,
probe_cluster_kernel<V>).

On the CPU: the initial state's offset making every row and lane differ,
and a wrong roll, a skipped exchange or a row written in another's place
change the result; the carcass with the offset against numpy; live walks
(walk_floor above the row maxima) that emit, and that a walk started from
one row's maximum instead of all 8's would change; the wrappers' routing
to the cluster instance by default and to the one-block instance on
request, and the offset and walk_floor reaching the launch, seen through
a stand-in for the library's probe_loop_launch (no card); a refused
cluster launch raising with no one-block launch after it; the CPU
wrappers running the one plain version in either layout; the probe tool
printing both layouts; the SASS census naming the cluster instances. The
kernels themselves run only on a card (chip_smoke.py's `probes` and
`census` phases).
"""
import types

import numpy as np
import pytest
import torch

from twilight_tpu_torch.ops import build, probe_loop
from twilight_tpu_torch.tools import probe_loop_costs as port_tool
from twilight_tpu_torch.tools import sass_census

torch.set_num_threads(1)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(torch.int32)[~na], b.view(torch.int32)[~nb]))


@pytest.mark.parametrize("name", probe_loop.CLUSTER_VARIANTS)
def test_offset_makes_every_row_and_lane_differ(name):
    """With the offset every row differs from every other, lanes within a
    row differ, and the result differs from the tool's program."""
    small = probe_loop.REFERENCES[name](2, "cpu", True)
    assert small.shape == (probe_loop.GRP, probe_loop.W)
    assert not _bits_equal(small, probe_loop.REFERENCES[name](2, "cpu"))
    assert len({tuple(r.tolist()) for r in small}) == probe_loop.GRP
    assert len(set(small[0].tolist())) > 1


def test_offset_is_exact():
    """g * 2^-7 + x * 2^-12 in f32 equals its exact value."""
    off = probe_loop._offset("cpu")
    g = torch.arange(probe_loop.GRP, dtype=torch.float64)[:, None]
    x = torch.arange(probe_loop.W, dtype=torch.float64)
    assert torch.equal(off.double(), g / 128 + x / 4096)


# the variants whose body rolls its rows by a lane: all but the carcass
ROLL_VARIANTS = [n for n in probe_loop.CLUSTER_VARIANTS if n != "carcass"]


@pytest.mark.parametrize("name", ROLL_VARIANTS)
def test_offset_makes_a_wrong_roll_visible(monkeypatch, name):
    """A roll that takes the wrong lane (by two lanes, not one) leaves
    the tool's uniform state unchanged, and changes it with the offset."""
    want = {o: probe_loop.REFERENCES[name](2, "cpu", o)
            for o in (False, True)}
    roll = torch.roll
    monkeypatch.setattr(torch, "roll", lambda x, s, d: roll(x, s + 1, d))
    got = {o: probe_loop.REFERENCES[name](2, "cpu", o)
           for o in (False, True)}
    assert _bits_equal(got[False], want[False])
    assert not _bits_equal(got[True], want[True])


@pytest.mark.parametrize("name", probe_loop.CLUSTER_VARIANTS)
def test_offset_makes_a_wrong_row_visible(name):
    """A cluster instance whose CTA g wrote its result into row g + 1 (the
    plain version's rows rolled by one group row) gives the tool's result,
    which is the same in every row, and another with the offset."""
    want = {o: probe_loop.REFERENCES[name](2, "cpu", o)
            for o in (False, True)}
    got = {o: torch.roll(w, 1, 0) for o, w in want.items()}
    assert _bits_equal(got[False], want[False])
    assert not _bits_equal(got[True], want[True])


@pytest.mark.parametrize("layout", probe_loop.LAYOUTS)
@pytest.mark.parametrize("trips", [2, 6, 40])
def test_carcass_offset_matches_numpy(trips, layout):
    """The carcass with the offset, through either layout's CPU wrapper,
    equals the same program in numpy f32 from the same start: row i at
    i + g * 2^-7 + x * 2^-12, column i at i + g, +1 each a body, then
    0 + r0 + ... + r7 + float(c0)."""
    g = np.arange(probe_loop.GRP, dtype=np.float32)[:, None]
    x = np.arange(probe_loop.W, dtype=np.float32)
    off = g * np.float32(2.0 ** -7) + x * np.float32(2.0 ** -12)
    rows = [np.float32(i) + off for i in range(probe_loop.N_ROWS)]
    col0 = np.arange(probe_loop.GRP, dtype=np.int32)[:, None]
    for _ in range(probe_loop.loop_steps(trips)):
        rows = [r + np.float32(1.0) for r in rows]
        col0 = col0 + 1
    want = np.zeros((probe_loop.GRP, probe_loop.W), dtype=np.float32)
    for r in rows:
        want = want + r
    want = want + col0.astype(np.float32)
    assert want.dtype == np.float32
    out = torch.empty((probe_loop.GRP, probe_loop.W))
    got = probe_loop.carcass(trips, out, layout, offset=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, probe_loop.carcass_reference(trips)
                              .numpy())


@pytest.mark.parametrize("variant", ["body", "both"])
def test_offset_makes_a_skipped_exchange_visible(monkeypatch, variant):
    """A CTA that skipped the exchange would compute org from its own row
    maximum alone. Over the tool's state that is the org of all rows;
    with the offset, at 2 and 6 trips, some row's own org differs, so
    its output row (+ org) would."""
    next_org = probe_loop._next_org
    for offset, differs in ((False, False), (True, True)):
        for trips in (2, 6):
            seen = []

            def spy(org, msp):
                seen.append(msp.clone())
                return next_org(org, msp)
            monkeypatch.setattr(probe_loop, "_next_org", spy)
            probe_loop.scalar0d_reference(variant, trips, offset=offset)
            monkeypatch.setattr(probe_loop, "_next_org", next_org)
            org, own = 0, [0] * probe_loop.GRP
            for msp in seen:
                org = next_org(org, msp)
                own = [next_org(o, msp[g:g + 1]) for g, o in enumerate(own)]
            assert (own != [org] * probe_loop.GRP) == differs, \
                (offset, trips, org, own)


LIVE = 4096        # a walk_floor above every row maximum at 2 trips


@pytest.mark.parametrize("name", probe_loop.WALK_VARIANTS)
def test_live_walks_emit(name):
    """With the offset and walk_floor = LIVE at 2 trips the walks run
    (emit above 0 in every tile) and change the result; at WALK_FLOOR
    they emit nothing."""
    ref = probe_loop.REFERENCES[name]
    emits, dead = [], []
    live = ref(2, "cpu", True, LIVE, emits)
    off = ref(2, "cpu", True, probe_loop.WALK_FLOOR, dead)
    assert emits and min(emits) > 0 and set(dead) == {0}
    assert torch.isfinite(live).all()
    assert not _bits_equal(live, off)


@pytest.mark.parametrize("name", probe_loop.WALK_VARIANTS)
def test_live_walks_see_a_skipped_exchange(monkeypatch, name):
    """A CTA that skipped the exchange before the walks would start them
    from its own row maximum, not the maximum of all 8. That copy (each
    row's emit from its own row's walks) gives the tool's result at
    WALK_FLOOR, and another with the offset and live walks."""
    ref = probe_loop.REFERENCES[name]
    want = {wf: ref(2, "cpu", True, wf)
            for wf in (probe_loop.WALK_FLOOR, LIVE)}
    walks = probe_loop._dead_walks

    def own_row(msp, walk_floor, scratch):
        return torch.tensor([[float(walks(msp[g:g + 1], walk_floor,
                                          scratch))]
                             for g in range(probe_loop.GRP)])
    monkeypatch.setattr(probe_loop, "_dead_walks", own_row)
    got = {wf: ref(2, "cpu", True, wf) for wf in want}
    assert _bits_equal(got[probe_loop.WALK_FLOOR], want[probe_loop.WALK_FLOOR])
    assert not _bits_equal(got[LIVE], want[LIVE])


@pytest.mark.parametrize("trips", [2, 6])
def test_scratch_with_offset_is_finite(trips):
    """body/scratch with the offset starts from body/carried's rows plus
    the offset, not from NaN: finite, and equal to body/carried's."""
    got = probe_loop.REFERENCES["body/scratch"](trips, "cpu", True)
    assert torch.isfinite(got).all()
    assert _bits_equal(got, probe_loop.REFERENCES["body/carried"](
        trips, "cpu", True))
    assert torch.isnan(probe_loop.REFERENCES["body/scratch"](trips,
                                                             "cpu")).all()


class _CudaOut:
    """Stands in for a contiguous f32 (8, 640) CUDA tensor."""
    dtype = torch.float32
    shape = (probe_loop.GRP, probe_loop.W)
    device = torch.device("cuda", 0)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0x1000


class _Calls(list):
    rc = 0          # what the stand-in probe_loop_launch returns

    def __init__(self):
        super().__init__()
        self.offsets = []       # the offset argument of each call
        self.walk_floors = []   # the walk_floor argument of each call


@pytest.fixture
def launches(monkeypatch):
    """The (variant id, cluster) of each probe_loop_launch call, through
    a stand-in library that only a load of the probes' source gets."""
    calls = _Calls()

    def probe_loop_launch(variant, cluster, trips, walk_floor, offset, out,
                          stream):
        calls.append((variant, cluster))
        calls.offsets.append(offset)
        calls.walk_floors.append(walk_floor)
        return calls.rc

    lib = types.SimpleNamespace(probe_loop_launch=probe_loop_launch)
    monkeypatch.setattr(build, "load",
                        lambda source: lib if source == build.PROBE else None)
    monkeypatch.setattr(build, "error_string", lambda rc: "stand-in error")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    probe_loop.reset_launches()
    yield calls
    probe_loop.reset_launches()


@pytest.mark.parametrize("name", list(probe_loop.KERNEL_ID))
def test_wrappers_route_by_layout(launches, name):
    """Every variant, the carcass too, launches its cluster instance by
    default and the one-block instance with layout="block". Each launch
    counts once, a cluster launch also in cluster_launches."""
    vid = probe_loop.KERNEL_ID[name]
    fn = {"carcass": probe_loop.carcass, "deadcode": probe_loop.deadcode,
          "nested": probe_loop.nested, "scalar0d": probe_loop.scalar0d,
          "body": probe_loop.body}[name.split("/")[0].split("+")[0]]
    assert name in probe_loop.CLUSTER_VARIANTS
    probe_loop.run(name, 4, _CudaOut())
    assert launches == [(vid, 1)]
    probe_loop.run(name, 4, _CudaOut(), "block")
    assert launches[1:] == [(vid, 0)]
    assert (fn.launches, fn.cluster_launches) == (2, 1)
    assert sum(f.launches for f in probe_loop.WRAPPERS) == 2


@pytest.mark.parametrize("layout", probe_loop.LAYOUTS)
@pytest.mark.parametrize("name", probe_loop.CLUSTER_VARIANTS)
def test_offset_reaches_the_launch(launches, name, layout):
    """offset=True reaches probe_loop_launch in either layout; the
    default launches without it."""
    probe_loop.run(name, 4, _CudaOut(), layout, offset=True)
    probe_loop.run(name, 4, _CudaOut(), layout)
    vid, cluster = probe_loop.KERNEL_ID[name], int(layout == "cluster")
    assert launches == [(vid, cluster)] * 2
    assert launches.offsets == [1, 0]


@pytest.mark.parametrize("layout", probe_loop.LAYOUTS)
@pytest.mark.parametrize("name", ["deadcode", "nested", "nested+walk"])
def test_walk_floor_reaches_the_launch(launches, name, layout):
    """walk_floor reaches probe_loop_launch in either layout; the default
    launches with WALK_FLOOR."""
    probe_loop.run(name, 2, _CudaOut(), layout, True, LIVE)
    probe_loop.run(name, 2, _CudaOut(), layout)
    vid, cluster = probe_loop.KERNEL_ID[name], int(layout == "cluster")
    assert launches == [(vid, cluster)] * 2
    assert launches.walk_floors == [LIVE, probe_loop.WALK_FLOOR]
    assert launches.offsets == [1, 0]


@pytest.mark.parametrize("name", [n for n in probe_loop.KERNEL_ID if
                                  n.split("/")[0].split("+")[0]
                                  not in ("deadcode", "nested")])
def test_walk_floor_only_for_deadcode_and_nested(launches, name):
    with pytest.raises(ValueError, match="takes no walk_floor"):
        probe_loop.run(name, 2, _CudaOut(), walk_floor=LIVE)
    assert launches == []


@pytest.mark.parametrize("name", probe_loop.CLUSTER_VARIANTS)
def test_refused_cluster_launch_raises_without_fallback(launches, name):
    launches.rc = 2
    with pytest.raises(RuntimeError, match="cluster launch failed"):
        probe_loop.run(name, 4, _CudaOut())
    assert launches == [(probe_loop.KERNEL_ID[name], 1)]
    assert sum(f.launches + f.cluster_launches
               for f in probe_loop.WRAPPERS) == 0


def test_layout_names_are_checked():
    out = torch.empty((probe_loop.GRP, probe_loop.W))
    with pytest.raises(ValueError, match="layout"):
        probe_loop.run("nested", 2, out, "grid")
    with pytest.raises(ValueError, match="layout"):
        probe_loop.scalar0d("both", 2, out, layout="tile")


@pytest.mark.parametrize("name", probe_loop.CLUSTER_VARIANTS)
def test_cpu_wrapper_runs_its_layouts_plain_version(monkeypatch, name):
    """On a CPU tensor both layouts run the variant's one plain version,
    with the same arguments and the same result; neither counts a
    launch."""
    seen = []
    for fn in (probe_loop.carcass_reference, probe_loop.body_reference,
               probe_loop.scalar0d_reference, probe_loop.deadcode_reference,
               probe_loop.nested_reference):
        def spy(*args, _fn=fn, **kw):
            seen.append((_fn.__name__, args, kw))
            return _fn(*args, **kw)
        monkeypatch.setattr(probe_loop, fn.__name__, spy)
    out = torch.empty((probe_loop.GRP, probe_loop.W))
    got = {layout: probe_loop.run(name, 2, out, layout, True).clone()
           for layout in probe_loop.LAYOUTS}
    assert len(seen) == 2 and seen[0] == seen[1]
    assert _bits_equal(got["cluster"], got["block"])
    assert sum(f.launches for f in probe_loop.WRAPPERS) == 0


@pytest.mark.parametrize("what,names", [
    ("carcass", ["carcass rows=8 cols=20"]),
    ("scalar0d", ["body/carried", "scalar0d/cond", "scalar0d/body",
                  "scalar0d/both"]),
    ("nested", ["body/carried", "nested(2 tiles)", "nested(2 tiles)+walk"]),
    ("body", ["body/carried", "body/scratch"]),
    ("deadcode", ["body/carried", "deadcode"])])
def test_port_tool_prints_both_layouts(capsys, what, names):
    """`--device cpu` prints each K6-K10 variant twice: the cluster
    instance under the JAX tool's label, then the one-block instance."""
    assert port_tool.main([what, "--device", "cpu", "--trips", "2",
                           "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()[1:]
    labels = [ln.split(": ")[0] for ln in lines]
    for label in names:
        k = labels.index(label)
        assert labels[k + 1] == label + port_tool.BLOCK_SUFFIX
    for ln in lines:
        float(ln.split(": ")[1].split()[0])


@pytest.mark.parametrize("exchange", port_tool.EXCHANGES)
def test_cluster_exchange_needs_the_card(capsys, exchange):
    """--cluster-exchange rebuilds the cluster instances, on the card
    only; `barrier` adds -DPROBE_CLUSTER_EXCHANGE=1, `async` nothing."""
    with pytest.raises(SystemExit) as e:
        port_tool.main(["scalar0d", "--device", "cpu", "--cluster-exchange",
                        exchange])
    assert e.value.code == 2
    assert "--cluster-exchange" in capsys.readouterr().err
    assert port_tool.exchange_flags(exchange) == (
        ("-DPROBE_CLUSTER_EXCHANGE=1",) if exchange == "barrier" else ())


def test_census_names_the_cluster_instances():
    """The census names each probe instance's variant and layout, and
    counts the cluster barrier's arrive, wait and error barrier as
    barriers and st.async (STAS) as a shared-memory store."""
    listing = """
		Function : _ZN12_GLOBAL__N_120probe_cluster_kernelILi5EEEviiPf
        /*0000*/                   UCGABAR_ARV ;                           /* 0x00000000000079ad */
        /*0010*/                   UCGABAR_WAIT ;                          /* 0x0000000000007dad */
        /*0020*/                   CGAERRBAR ;                             /* 0x00000000000075ab */
        /*0030*/                   STAS [R2], R3 ;                         /* 0x00000003020073ad */
        /*0040*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R5 ;  /* 0x00000005ff0075a7 */
        /*0050*/                   EXIT ;                                  /* 0x000000000000794d */
		Function : _ZN12_GLOBAL__N_117probe_loop_kernelILi5EEEviiPf
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
"""
    res = sass_census.census(listing)
    assert {k: (v["variant"], v["layout"]) for k, v in res.items()} == {
        "probe_cluster_kernel<5>": ("scalar0d/both", "cluster"),
        "probe_loop_kernel<5>": ("scalar0d/both", "block")}
    c = res["probe_cluster_kernel<5>"]["classes"]
    assert (c["barrier"], c["shared"], c["branch"], c["other"]) == (4, 1, 1, 0)
