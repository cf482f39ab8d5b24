"""The reader of the batcher's count of long launches issued beside an
earlier one (`long_beside_launch_share`) on hand-made records: the share
with the counters, and None without them (a program that lacks the
counter, or an untraced run) or with no long launch."""
import pytest

from msabench import spec


def _read(**stats):
    return spec.reader("long_beside_launch_share")(
        {"align_s": [3.0, 5.0], "stats": stats})


@pytest.mark.parametrize("beside,launches,share", [
    (14, 53, 100.0 * 14 / 53), (0, 53, 0.0), (5, 5, 100.0)])
def test_share(beside, launches, share):
    assert _read(**{"count.launches_long_beside": beside,
                    "count.launches_long": launches}) == pytest.approx(share)


@pytest.mark.parametrize("stats", [
    {"pairs": 4},
    {"count.launches_long": 53, "count.pairs_long_launched": 999},
    {"count.launches_long_beside": 0, "count.launches_long": 0},
    {"count.launches_long_beside": 3}])
def test_nothing_to_read(stats):
    assert _read(**stats) is None


def test_benchmark_lists_the_reader():
    """A per-layer entry of the batcher that moves msa_s in nt.sars_long."""
    m = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[
        "long_beside_launch_share"]
    assert (m["source"], m["moves"], m["layer"], m["better"], m["unit"]) == (
        "program_counter", "msa_s", "batcher", "higher", "%")
    assert m["workloads"] == ["nt.sars_long"]
