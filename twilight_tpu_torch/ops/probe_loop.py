"""Loop-cost probes on an NVIDIA Hopper GPU: the CUDA kernels' wrappers,
their plain PyTorch versions and their launch counters.

The counterparts of the five Pallas probe kernels of
`tools/probe_loop_costs.py` (K6-K10), which time the per-step floor of a
DP-like anti-diagonal body in one program. Each computes a (GRP, W) =
(8, 640) f32 result after `trips` loop steps (two bodies per loop trip):

- `carcass` (K6, `pallas_call` at :86): 8 carried (8, 640) rows and 20
  int32 (8, 1) columns, +1 per body;
- `body` (K7, :144), variants `carried` / `scratch`: a 30-op DP-like body
  (6-term weighted sum, 2 lane rolls, max/where, one row max) on 8 rows
  held in the loop state or in a (64, 640) scratch;
- `scalar0d` (K8, :239), variants `cond` / `body` / `both`: `body/carried`
  plus 0-d min/max/any reductions that feed a carried scalar `org` and/or
  the loop condition;
- `deadcode` (K9, :317): `body/carried` plus 8 zero-trip traceback walks
  over an int8 (8, 2048) scratch and a never-taken merge;
- `nested` (K10, :391): `body/carried` inside a 2-trip outer loop whose
  state seeds the inner loop, optionally with dead walks.

The kernels are `csrc/probe_loop_costs.cu` (module doc there), in two
layouts. `block`: one block holds the whole (8, 640) state, as one TPU
program did. `cluster` (the default of every variant): one cluster of 8
CTAs, CTA g holding group row g, the rows meeting only where the program
combines them, through distributed shared memory: scalar0d/body and
/both every body (st.async stores that complete the receiving CTA's
mbarrier), deadcode after its loop and nested+walk at each tile's end (a
cluster barrier); carcass, body, scalar0d/cond and nested exchange
nothing. A wrapper given a CPU tensor runs the variant's one plain
version, whatever the layout; given a CUDA tensor it launches the kernel
on the current stream, or raises: a refused cluster launch never falls
back to one block.

`offset=True` (every variant, either layout and the plain versions)
starts the carried rows (body/scratch: its scratch) at base + g * 2^-7 +
x * 2^-12 (group row g, lane x), and the carcass's 20 columns at i + g:
the tool's state is the same in every row and lane, and the offset makes
a value routed to the wrong lane, CTA or slot, or a row written in
another's place, change the result.

`walk_floor` (deadcode and nested): the walks start at done =
min(int(max(msp)), walk_floor). The tool's WALK_FLOOR keeps them dead;
above the row maxima they run, and with the offset (row maxima that
differ by row) a walk started from one row's maximum instead of all 8's
changes the result.

`body/scratch` reads its scratch before it writes it: on the TPU the
result is undefined, and the JAX interpreter fills float scratch with
NaN. The kernel and the plain version fill it with NaN too, so all three
agree (with the offset: body/carried's start, so its result is finite).
deadcode's int8 scratch starts at TBS_FILL, the interpreter's value for
uninitialised int8 scratch, in the kernel and the plain version alike.
"""
from __future__ import annotations

import ctypes

import torch

GRP, W = 8, 640
N_ROWS, N_COLS = 8, 20          # carcass state
INT32_MAX = (1 << 31) - 1
# done = min(max(msp), WALK_FLOOR) < 0: the walks run zero trips. The
# kernel takes it as an argument, so that nvcc cannot drop the dead code
# that the probe keeps in scope.
WALK_FLOOR = -1
TBW = 2048                      # deadcode's int8 scratch: (GRP, TBW)
TBS_FILL = -128                 # its start (the int8 minimum)

# kernel ids of probe_loop_launch (csrc/probe_loop_costs.cu)
KERNEL_ID = {"carcass": 0, "body/carried": 1, "body/scratch": 2,
             "scalar0d/cond": 3, "scalar0d/body": 4, "scalar0d/both": 5,
             "deadcode": 6, "nested": 7, "nested+walk": 8}
BODY_VARIANTS = ("carried", "scratch")
SCALAR0D_VARIANTS = ("cond", "body", "both")
LAYOUTS = ("cluster", "block")     # the first is every variant's default
# the variants with a cluster instance: all nine
CLUSTER_VARIANTS = tuple(KERNEL_ID)
# the variants whose walks start at walk_floor
WALK_VARIANTS = ("deadcode", "nested+walk")


def loop_steps(trips: int) -> int:
    """Bodies one inner loop runs: `while k < trips` with two bodies
    (k += 1 each) per loop trip."""
    return 2 * (-(-max(trips, 0) // 2))


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _check(out: torch.Tensor, trips: int) -> None:
    if out.dtype != torch.float32 or tuple(out.shape) != (GRP, W) \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous f32 ({GRP}, {W}) "
                         "tensor")
    if not 0 <= trips <= INT32_MAX - 2:
        raise ValueError(f"trips must be in 0..{INT32_MAX - 2}")
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {out.device}")


def _layout(layout: str) -> bool:
    """Whether `layout` is the cluster instance."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}")
    return layout == "cluster"


def _launch(kind: str, trips: int, out: torch.Tensor,
            cluster: bool = False, offset: bool = False,
            walk_floor: int = WALK_FLOOR) -> None:
    from . import build
    lib = build.load(build.PROBE)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.probe_loop_launch(KERNEL_ID[kind], int(cluster), trips,
                               walk_floor, int(offset),
                               ctypes.c_void_p(out.data_ptr()),
                               ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"probe_loop {kind} "
                           f"{'cluster' if cluster else 'block'} launch "
                           f"failed: {build.error_string(rc)} (cudaError "
                           f"{rc})")


def carcass(trips: int, out: torch.Tensor, layout: str = "cluster",
            offset: bool = False) -> torch.Tensor:
    """K6 into `out` ((8, 640) f32; the kernel on CUDA, else plain), as
    one cluster of 8 CTAs or (layout `block`) one block; `offset`: module
    doc."""
    cluster = _layout(layout)
    _check(out, trips)
    if out.device.type == "cpu":
        return out.copy_(carcass_reference(trips, offset=offset))
    _launch("carcass", trips, out, cluster, offset)
    carcass.launches += 1
    carcass.cluster_launches += cluster
    return out


def body(variant: str, trips: int, out: torch.Tensor,
         layout: str = "cluster", offset: bool = False) -> torch.Tensor:
    """K7, variant `carried` or `scratch`, into `out`, as one cluster of
    8 CTAs or (layout `block`) one block; `offset`: module doc."""
    if variant not in BODY_VARIANTS:
        raise ValueError(f"body variant must be one of {BODY_VARIANTS}")
    cluster = _layout(layout)
    _check(out, trips)
    if out.device.type == "cpu":
        return out.copy_(body_reference(variant, trips, offset=offset))
    _launch(f"body/{variant}", trips, out, cluster, offset)
    body.launches += 1
    body.cluster_launches += cluster
    return out


def scalar0d(variant: str, trips: int, out: torch.Tensor,
             layout: str = "cluster", offset: bool = False) -> torch.Tensor:
    """K8, variant `cond`, `body` or `both`, into `out`, as one cluster
    of 8 CTAs or (layout `block`) one block; `offset`: module doc."""
    if variant not in SCALAR0D_VARIANTS:
        raise ValueError(
            f"scalar0d variant must be one of {SCALAR0D_VARIANTS}")
    cluster = _layout(layout)
    _check(out, trips)
    if out.device.type == "cpu":
        return out.copy_(scalar0d_reference(variant, trips, offset=offset))
    _launch(f"scalar0d/{variant}", trips, out, cluster, offset)
    scalar0d.launches += 1
    scalar0d.cluster_launches += cluster
    return out


def deadcode(trips: int, out: torch.Tensor, layout: str = "cluster",
             offset: bool = False,
             walk_floor: int = WALK_FLOOR) -> torch.Tensor:
    """K9 into `out`, as one cluster of 8 CTAs or (layout `block`) one
    block; `offset` and `walk_floor`: module doc."""
    cluster = _layout(layout)
    _check(out, trips)
    if out.device.type == "cpu":
        return out.copy_(deadcode_reference(trips, offset=offset,
                                            walk_floor=walk_floor))
    _launch("deadcode", trips, out, cluster, offset, walk_floor)
    deadcode.launches += 1
    deadcode.cluster_launches += cluster
    return out


def nested(with_walk: bool, trips: int, out: torch.Tensor,
           layout: str = "cluster", offset: bool = False,
           walk_floor: int = WALK_FLOOR) -> torch.Tensor:
    """K10 (with or without the dead walks) into `out`, as one cluster of
    8 CTAs or (layout `block`) one block; `offset` and `walk_floor`:
    module doc."""
    name = "nested+walk" if with_walk else "nested"
    cluster = _layout(layout)
    _check(out, trips)
    if out.device.type == "cpu":
        return out.copy_(nested_reference(with_walk, trips, offset=offset,
                                          walk_floor=walk_floor))
    _launch(name, trips, out, cluster, offset, walk_floor)
    nested.launches += 1
    nested.cluster_launches += cluster
    return out


# launches: every launch of the wrapper; cluster_launches: those of its
# cluster instances
WRAPPERS = (carcass, body, scalar0d, deadcode, nested)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = fn.cluster_launches = 0


reset_launches()


def run(name: str, trips: int, out: torch.Tensor, layout: str = "cluster",
        offset: bool = False, walk_floor: int = WALK_FLOOR) -> torch.Tensor:
    """One of the nine variants by its name in KERNEL_ID, in `layout`;
    `walk_floor` for deadcode and nested only."""
    if name not in KERNEL_ID:
        raise ValueError(f"unknown probe {name!r}")
    family, _, variant = name.partition("/")
    if walk_floor != WALK_FLOOR and family not in ("deadcode", "nested",
                                                   "nested+walk"):
        raise ValueError(f"{name} takes no walk_floor (those that do are "
                         "deadcode and nested)")
    if name == "carcass":
        return carcass(trips, out, layout, offset)
    if family == "body":
        return body(variant, trips, out, layout, offset)
    if family == "scalar0d":
        return scalar0d(variant, trips, out, layout, offset)
    if family == "deadcode":
        return deadcode(trips, out, layout, offset, walk_floor)
    return nested(name == "nested+walk", trips, out, layout, offset,
                  walk_floor)


def attributes(name: str, layout: str = "cluster") -> dict:
    """cudaFuncGetAttributes of one variant's kernel in `layout` (needs a
    CUDA device): registers and local (spill) bytes per thread, static
    shared bytes, maximum threads per block; the launch's threads a
    block and blocks a cluster; and for a cluster,
    cudaOccupancyMaxActiveClusters of its launch (None for one block)."""
    from . import build
    cluster = _layout(layout)
    out = (ctypes.c_int * 7)()
    rc = build.load(build.PROBE).probe_loop_attributes(
        KERNEL_ID[name], int(cluster), out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: "
                           f"{build.error_string(rc)} (cudaError {rc})")
    res = dict(zip(("registers", "local_bytes", "static_shared_bytes",
                    "max_threads_per_block", "threads", "cluster_size",
                    "max_active_clusters"), (int(v) for v in out)))
    if not cluster:
        res["max_active_clusters"] = None
    return res


# ----------------------------------------------------------------------
# plain PyTorch versions: the JAX tool's programs, op for op
# ----------------------------------------------------------------------

def _max(a, b):
    return torch.maximum(a, b)       # propagates NaN, as jnp.maximum


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA and CUDA convert: toward zero, saturating at
    the int32 range, NaN to 0 (a plain .to() is undefined out of range
    on the CPU)."""
    t = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, 2147483520.0)
    t = t.trunc().to(torch.int32)
    return torch.where(x >= 2.0 ** 31, torch.tensor(INT32_MAX,
                                                    dtype=torch.int32,
                                                    device=x.device), t)


def _math(r, msp):
    """The 30-op DP-like body (the tool's `math`, repeated at :98, :168,
    :255, :334): 8 new rows and the running row max."""
    sim = r[0] * 1.1 + r[1] * 0.9 + r[2] * 1.2 \
        + r[3] * 0.8 + r[4] * 1.3 + r[5] * 0.7
    diag = torch.roll(r[0], 1, 1) + sim
    up = r[1] + (-5.0)
    left = torch.roll(r[2], 1, 1) + (-3.0)
    m2 = _max(_max(diag, up), left)
    i_v = torch.where(left > up, left, up) + sim * 0.1
    d_v = torch.where(up > diag, up, diag) + sim * 0.2
    s_v = _max(m2, _max(i_v, d_v))
    c1 = torch.where(s_v > 0, r[3], r[4])
    c2 = torch.where(i_v > 0, r[5], r[6])
    c3 = torch.where(d_v > 0, r[6], r[7])
    mx = torch.amax(s_v, dim=1, keepdim=True)
    return [s_v, i_v, d_v, c1, c2, c3, sim + s_v * 0.01,
            diag + i_v * 0.01], _max(msp, mx)


def _rows(device, fill=None):
    return [torch.full((GRP, W), float(i) + 1.0 if fill is None else fill,
                       dtype=torch.float32, device=device)
            for i in range(N_ROWS)]


def _msp0(device):
    return torch.full((GRP, 1), -1e3, dtype=torch.float32, device=device)


def _offset(device) -> torch.Tensor:
    """The initial state's offset (module doc): g * 2^-7 + x * 2^-12 at
    group row g, lane x, exact in f32."""
    g = torch.arange(GRP, dtype=torch.float32, device=device)
    x = torch.arange(W, dtype=torch.float32, device=device)
    return g[:, None] * 2.0 ** -7 + x * 2.0 ** -12


def carcass_reference(trips: int, device="cpu",
                      offset: bool = False) -> torch.Tensor:
    """`offset`: row i starts at i + the offset, column i at i + g
    (module doc)."""
    rows = [torch.full((GRP, W), float(i), dtype=torch.float32,
                       device=device) for i in range(N_ROWS)]
    if offset:
        rows = [r + _offset(device) for r in rows]
    g = torch.arange(GRP, dtype=torch.int32, device=device)[:, None]
    cols = [torch.full((GRP, 1), i, dtype=torch.int32, device=device)
            + (g if offset else 0) for i in range(N_COLS)]
    for _ in range(loop_steps(trips)):
        rows = [r + 1.0 for r in rows]
        cols = [c + 1 for c in cols]
    acc = torch.zeros((GRP, W), dtype=torch.float32, device=device)
    for r in rows:
        acc = acc + r
    return acc + cols[0].to(torch.float32)


def _carried_loop(rows, msp, trips):
    for _ in range(loop_steps(trips)):
        rows, msp = _math(rows, msp)
    return rows, msp


def _start(device, offset: bool, fill=None):
    """The carried rows' start: base (i + 1, or `fill`) in every lane,
    plus the offset (module doc) when asked for."""
    rows = _rows(device, fill)
    if offset:
        rows = [r + _offset(device) for r in rows]
    return rows


def body_reference(variant: str, trips: int, device="cpu",
                   offset: bool = False) -> torch.Tensor:
    # `scratch` starts from the NaN-filled scratch, or with the offset
    # from `carried`'s start (module doc)
    fill = None if variant == "carried" or offset else float("nan")
    rows, msp = _carried_loop(_start(device, offset, fill), _msp0(device),
                              trips)
    return rows[0] + msp


def _next_org(org: int, msp: torch.Tensor) -> int:
    """scalar0d's 0-d reductions over the (GRP, 1) row maxima, into the
    carried `org`."""
    alive = msp > -2e3
    nl = torch.where(alive, (_to_int32(msp) & 0x7) + 1,
                     torch.tensor(2 ** 30, dtype=torch.int32,
                                  device=msp.device))
    nu = torch.where(alive, _to_int32(msp) & 0x3,
                     torch.tensor(0, dtype=torch.int32, device=msp.device))
    lmin, umax = int(nl.min()), int(nu.max())
    if bool(alive.any()):
        org = max(org, min(lmin, umax))
    return min(org, 7)


def scalar0d_reference(variant: str, trips: int, device="cpu",
                       offset: bool = False) -> torch.Tensor:
    """`offset`: module doc."""
    lane_w = torch.arange(W, dtype=torch.int32, device=device)
    rows, msp = _start(device, offset), _msp0(device)
    org = 0
    run = torch.ones((GRP, 1), dtype=torch.int32, device=device)
    cnt = torch.zeros((GRP, 1), dtype=torch.int32, device=device)
    k = 0
    while True:
        if variant in ("cond", "both"):
            if not (bool((run != 0).any()) and k < trips):
                break
        elif not k < trips:
            break
        for _ in range(2):
            x_rel = lane_w - org % W
            bias = torch.where(x_rel < 0, torch.tensor(0.0, device=device),
                               torch.tensor(1e-30, device=device))
            rows, msp = _math([rows[0] + bias] + rows[1:], msp)
            k += 1
            if variant in ("body", "both"):
                org = _next_org(org, msp)
            run = (cnt + 1 < trips).to(torch.int32)
            cnt = cnt + 1
    return rows[0] + msp + float(org)


def _dead_walks(msp: torch.Tensor, walk_floor: int, scratch: bool):
    """Steps of the GRP traceback walks, each from done =
    min(int(max(msp)), walk_floor) while done >= 0, stepping as the JAX
    tool's wstep: deadcode's (`scratch`) reads its int8 scratch, all
    TBS_FILL, at idx % 128 of the 128-lane block at idx; nested+walk's
    sums a one-hot over 128 lanes, which is 1. At WALK_FLOOR none runs
    and their emit is 0 (as is the merge, which fires above 1e9)."""
    done = min(int(_to_int32(msp.max())), walk_floor)
    tbs = [[TBS_FILL] * TBW for _ in range(GRP)] if scratch else None
    emit = 0
    for g in range(GRP):
        ftr, idx, n = done, 5, 0
        while ftr >= 0:
            if scratch:
                base = min((min(max(idx, 0), 1 << 20) // 128) * 128,
                           TBW - 128)
                v = tbs[g][base + idx % 128]
                ftr, idx = ftr - 1 - (v & 1), idx - (v & 2) // 2
            else:
                v = 1
                ftr, idx = ftr - 1 - (v & 1), idx - 1
            n += 1
        emit += n
    return emit


def deadcode_reference(trips: int, device="cpu", offset: bool = False,
                       walk_floor: int = WALK_FLOOR,
                       emits: list = None) -> torch.Tensor:
    """`offset` and `walk_floor`: module doc; `emits`, if given, receives
    the walks' emit."""
    rows, msp = _carried_loop(_start(device, offset), _msp0(device), trips)
    emit = _dead_walks(msp, walk_floor, True)
    if emits is not None:
        emits.append(emit)
    return rows[0] + msp + emit


def nested_reference(with_walk: bool, trips: int, device="cpu",
                     offset: bool = False, walk_floor: int = WALK_FLOOR,
                     emits: list = None) -> torch.Tensor:
    """`offset` and `walk_floor`: module doc; `emits`, if given, receives
    each tile's walk emit (nested+walk)."""
    acc = torch.zeros((GRP, W), dtype=torch.float32, device=device)
    for _ in range(2):
        rows = [acc * 0.001 + (i + 1.0) for i in range(N_ROWS)]
        if offset:
            rows = [r + _offset(device) for r in rows]
        rows, msp = _carried_loop(rows, _msp0(device), trips)
        emit = _dead_walks(msp, walk_floor, False) if with_walk else 0
        if with_walk and emits is not None:
            emits.append(emit)
        acc = rows[0] + msp + emit
    return acc


# the plain versions; each takes the offset as a third argument, those
# of WALK_VARIANTS also walk_floor and emits
REFERENCES = {
    "carcass": lambda t, d, o=False: carcass_reference(t, d, o),
    "body/carried": lambda t, d, o=False: body_reference("carried", t, d,
                                                         o),
    "body/scratch": lambda t, d, o=False: body_reference("scratch", t, d,
                                                         o),
    "scalar0d/cond": lambda t, d, o=False: scalar0d_reference(
        "cond", t, d, o),
    "scalar0d/body": lambda t, d, o=False: scalar0d_reference(
        "body", t, d, o),
    "scalar0d/both": lambda t, d, o=False: scalar0d_reference(
        "both", t, d, o),
    "deadcode": lambda t, d, o=False, wf=WALK_FLOOR, e=None:
        deadcode_reference(t, d, o, wf, e),
    "nested": lambda t, d, o=False: nested_reference(False, t, d, o),
    "nested+walk": lambda t, d, o=False, wf=WALK_FLOOR, e=None:
        nested_reference(True, t, d, o, wf, e),
}
