"""prot_16 through the port's command line with other substitution
matrices, its kernel plain version forced (--backend cpu, every pair on the
device, no stealing) and its --backend native:

- (b) -b 45 and -b 80, byte-equal to the reference TWILIGHT's outputs
  (tests/golden/prot_16.b45.aln, .b80.aln);
- (c) -x with BLOSUM62 written out as -b 62 scores it, and -x with a
  changed matrix in another letter order (chip_smoke.changed_blosum62),
  each byte-equal to the JAX CLI's --backend native output, and each
  output's md5 the one chip_smoke.py's protein phase holds the card to.

Kept apart from tests/test_torch_protein.py so that the two files, each
with a forced run of a few minutes on the plain version, take two test
workers. Tolerance: exact FASTA bytes."""
import hashlib
import os

import pytest
import torch

from twilight_tpu import cli as tpu_cli
from twilight_tpu_torch import cli
from twilight_tpu_torch.config import Params, write_matrix_file

import chip_smoke
from conftest import DATA, GOLDEN

torch.set_num_threads(1)

KINDS = {"b45": ("prot_16.b45.aln", chip_smoke.GOLDEN_PROT16_B45),
         "b80": ("prot_16.b80.aln", chip_smoke.GOLDEN_PROT16_B80),
         "x62": (None, chip_smoke.GOLDEN_PROT16),
         "xchanged": (None, chip_smoke.GOLDEN_PROT16_XCHANGED)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _matrix_argv(kind, d):
    if kind.startswith("b"):
        return ["-b", kind[1:]]
    path = os.path.join(d, kind + ".x")
    if kind == "x62":
        write_matrix_file(path, "p", Params.make("p").scoring_matrix,
                          chip_smoke.AA20)
    else:
        write_matrix_file(path, "p", chip_smoke.changed_blosum62(),
                          chip_smoke.XCHANGED_ORDER)
    return ["-x", path]


@pytest.mark.parametrize("backend", ["cpu-forced", "native"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_prot16_matrix_matches_reference(tmp_path, monkeypatch, kind,
                                         backend):
    argv = ["-t", os.path.join(DATA, "prot_16.nwk"), "-i",
            os.path.join(DATA, "prot_16.fa"), "--type", "p",
            *_matrix_argv(kind, str(tmp_path))]
    golden, md5 = KINDS[kind]
    if golden is not None:
        want = _read(os.path.join(GOLDEN, golden))
    else:
        path = str(tmp_path / "jax.aln")
        assert tpu_cli.main(argv + ["--backend", "native", "-o", path]) == 0
        want = _read(path)
    assert hashlib.md5(want).hexdigest() == md5
    out = str(tmp_path / "port.aln")
    if backend == "native":
        rc, kernel = cli.run(argv + ["--backend", "native", "-o", out])
        assert rc == 0 and kernel is None
    else:
        monkeypatch.setenv("TWILIGHT_FORCE_DEVICE", "1")
        monkeypatch.setenv("TWILIGHT_NO_STEAL", "1")
        rc, kernel = cli.run(argv + ["--backend", "cpu", "-o", out])
        assert rc == 0
        st = kernel.stats
        assert st["pairs_on_device"] == st["pairs"] - st["zero_length"] == 15
        assert st["leaf_launches"] > 0
    assert _read(out) == want
