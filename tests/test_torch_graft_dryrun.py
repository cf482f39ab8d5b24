"""The port's multi-device dry run (twilight_tpu_torch/graft_entry.py
`dryrun_multichip`) over four CPU devices: every route on every device,
every pair equal to the NumPy oracle (the checks of
test_torch_graft_entry.check_dryrun; a file of its own, so that the two
dry runs take two test workers)."""
from test_torch_graft_entry import check_dryrun


def test_dryrun_multichip_on_four_cpu_devices(monkeypatch):
    check_dryrun(4, monkeypatch)
