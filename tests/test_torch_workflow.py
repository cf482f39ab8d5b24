"""The port's workflows (twilight_tpu_torch.workflow, tools.sp_score) held
to the JAX package's on the same inputs with --backend native: iterative
mode and placement mode md5-equal, with the same trees between iterations;
the Snakemake-style --config surface; the command line's exits."""
import hashlib
import os
import subprocess
import sys

import pytest
import torch

from twilight_tpu import cli as tpu_cli
from twilight_tpu.config import Params as TpuParams
from twilight_tpu.phylo.tree import Tree
from twilight_tpu.seqio.fasta import iter_fasta
from twilight_tpu.tools import sp_score as tpu_sp_score
from twilight_tpu.workflow import placement as tpu_placement
from twilight_tpu.workflow import run_iterative as tpu_run_iterative
from twilight_tpu.workflow import snakeconfig as tpu_snakeconfig
from twilight_tpu_torch.config import Params
from twilight_tpu_torch.tools import simulate, sp_score
from twilight_tpu_torch.workflow import iterative, placement, snakeconfig
from twilight_tpu_torch.workflow import run_iterative

from conftest import DATA, REPO


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("case", ["sim300-3", "prot16-2"])
def test_run_iterative_md5_equals_jax(tmp_path, case):
    if case == "sim300-3":
        prefix = str(tmp_path / "sim300")
        assert simulate.main(["-n", "300", "-l", "500", "--seed", "11",
                              "-o", prefix]) == 0
        seqs, iters, type_ = prefix + ".fa", 3, None
    else:
        seqs, iters, type_ = os.path.join(DATA, "prot_16.fa"), 2, "p"
    outs = {}
    for tag, fn in (("jax", tpu_run_iterative), ("port", run_iterative)):
        outs[tag] = str(tmp_path / f"{tag}.aln")
        steps = fn(seqs, outs[tag], iterations=iters,
                   temp_dir=str(tmp_path / f"wf_{tag}"), type_=type_,
                   backend="native", extra_args=["-C", "2"], keep_temp=True)
    assert _md5(outs["port"]) == _md5(outs["jax"])
    for it in range(iters):
        name = f"iter{it}.nwk"
        assert (_read(tmp_path / "wf_port" / name)
                == _read(tmp_path / "wf_jax" / name)), name
    want = ["kmer 0", "gram 0", "nj 0", "align 0"]
    for it in range(1, iters):
        want += [f"msa distances {it}", f"nj {it}", f"align {it}"]
    assert [s["step"] for s in steps] == want
    assert all(s["launches"] == 0 for s in steps if "launches" in s)


def test_iterative_with_card_products_md5_equals_jax(tmp_path, monkeypatch):
    """The workflow's card route (a CUDA device for the tree estimation,
    every gate at 0; the count products stubbed by their plain version on
    the CPU): the Gram product stays on the host, so the trees and the
    final MSA are the JAX package's with --backend native."""
    from twilight_tpu_torch.trees import estimate
    prefix = str(tmp_path / "sim300")
    assert simulate.main(["-n", "300", "-l", "300", "--seed", "12",
                          "-o", prefix]) == 0
    calls = []
    real = estimate.pair_counts_on

    def card(a, b, letters, device):
        calls.append(device)
        return real(a, b, letters, torch.device("cpu"))

    monkeypatch.setattr(estimate, "pair_counts_on", card)
    monkeypatch.setattr(estimate, "CARD_MIN_EST_S", 0.0)
    monkeypatch.setattr(iterative, "resolve",
                        lambda backend: ("native", torch.device("cuda")))
    outs = {}
    for tag, fn in (("jax", tpu_run_iterative), ("port", run_iterative)):
        outs[tag] = str(tmp_path / f"{tag}.aln")
        fn(prefix + ".fa", outs[tag], iterations=2,
           temp_dir=str(tmp_path / f"wf_{tag}"), backend="native",
           extra_args=["-C", "2"], keep_temp=True)
    assert calls == [torch.device("cuda")]
    for name in ("iter0.nwk", "iter1.nwk"):
        assert (_read(tmp_path / "wf_port" / name)
                == _read(tmp_path / "wf_jax" / name)), name
    assert _md5(outs["port"]) == _md5(outs["jax"])


@pytest.fixture(scope="module")
def backbone(tmp_path_factory):
    """40 simulated sequences of ~150 bases: 32 backbone rows aligned by
    the JAX command line on their pruned true tree, 8 queries."""
    d = tmp_path_factory.mktemp("place")
    prefix = str(d / "sim")
    assert simulate.main(["-n", "40", "-l", "150", "--seed", "11",
                          "-o", prefix]) == 0
    seqs = {n: s for n, _, s in iter_fasta(prefix + ".fa")}
    names = list(seqs)
    files = {k: str(d / k) for k in ("bb.fa", "q.fa", "bb.nwk", "bb.aln")}
    for key, part in (("bb.fa", names[:32]), ("q.fa", names[32:])):
        with open(files[key], "w") as f:
            f.writelines(f">{n}\n{seqs[n]}\n" for n in part)
    pruned = Tree.from_newick_file(prefix + ".nwk").prune(set(names[:32]))
    with open(files["bb.nwk"], "w") as f:
        f.write(pruned.get_newick_string() + "\n")
    assert tpu_cli.main(["-t", files["bb.nwk"], "-i", files["bb.fa"], "-o",
                         files["bb.aln"], "--backend", "native", "--rooted",
                         "-C", "2"]) == 0
    return files


@pytest.mark.parametrize("with_tree", [True, False],
                         ids=["with-tree", "without-tree"])
def test_run_placement_md5_equals_jax(tmp_path, backbone, with_tree):
    outs = {}
    for tag, fn in (("jax", tpu_placement.run_placement),
                    ("port", placement.run_placement)):
        outs[tag] = str(tmp_path / f"{tag}.aln")
        fn(backbone["q.fa"], backbone["bb.aln"], outs[tag],
           backbone_tree=backbone["bb.nwk"] if with_tree else None,
           iterations=2, temp_dir=str(tmp_path / f"wf_{tag}"),
           backend="native", extra_args=["-C", "2"], keep_temp=True)
    assert _md5(outs["port"]) == _md5(outs["jax"])
    assert (_read(tmp_path / "wf_port" / "tree_iter1.nwk")
            == _read(tmp_path / "wf_jax" / "tree_iter1.nwk"))


# ---------------------------------------------------------------------------
# --config: the reference Snakefile's keys, translated as the JAX package
# translates them
# ---------------------------------------------------------------------------

def _both(capsys, argv):
    """(result or exit code, stdout, stderr) of each package's
    config_to_argv."""
    res = []
    for mod in (snakeconfig, tpu_snakeconfig):
        try:
            got = mod.config_to_argv(list(argv))
        except SystemExit as e:
            got = ("exit", e.code)
        out = capsys.readouterr()
        res.append((got, out.out, out.err))
    return res


@pytest.mark.parametrize("case", [
    "translation", "placement-keys", "iter-6", "iter-0", "bogus-key",
    "malformed", "missing-out", "missing-seq"])
def test_config_to_argv_as_jax(tmp_path, capsys, case):
    out = f"OUT={tmp_path}/o.aln"
    argv = {
        "translation": ["-x", "--config", "TYPE=n", "SEQ=in.fa", out,
                        "ITER=4", "INITTREE=maffttree", "ITERTREE=rapidnj",
                        "FINALTREE=fasttree", "KEEP=yes",
                        f"DIR={tmp_path}/wd"],
        "placement-keys": ["--config", "TYPE=p", "SEQ=q.fa", out,
                           "ALN=bb.aln", "TREE=bb.nwk"],
        "iter-6": ["--config", "SEQ=in.fa", out, "ITER=6"],
        "iter-0": ["--config", "SEQ=in.fa", out, "ITER=0"],
        "bogus-key": ["--config", "SEQ=in.fa", out, "BOGUS=1"],
        "malformed": ["--config", "SEQ=in.fa", out, "ITER"],
        "missing-out": ["--config", "SEQ=in.fa"],
        "missing-seq": ["--config", out],
    }[case]
    got, want = _both(capsys, argv)
    assert got == want
    if case == "translation":
        assert got[0][:3] == ["-x", "-i", "in.fa"]
        assert ["--init-tree", "mafft"] == got[0][11:13]


def _help_body(text):
    """The help text bar its title and its note on defaults, with the
    command named as the JAX package names it."""
    return [line.replace("twilight-tpu-torch", "twilight-tpu")
            for line in text.splitlines()
            if "Mode (" not in line and "unspecified option" not in line]


def test_config_overwrite_guards_and_help_as_jax(tmp_path, capsys):
    out = tmp_path / "o.aln"
    out.write_text("x")
    wd = tmp_path / "wd"
    wd.mkdir()
    for argv in (["--config", "SEQ=in.fa", f"OUT={out}"],
                 ["--config", "SEQ=in.fa", f"OUT={out}", "OVERWRITE=yes"],
                 ["--config", "SEQ=in.fa", f"OUT={tmp_path}/n.aln",
                  f"DIR={wd}"],
                 ["--config"]):
        got, want = _both(capsys, argv)
        # the help text names the port's command; the rest is the same
        assert _help_body(got[1]) == _help_body(want[1])
        assert (got[0], got[2]) == (want[0], want[2])
    assert "twilight-tpu-torch-workflow --config" in snakeconfig.HELP


def test_config_run_drives_run_iterative(tmp_path, monkeypatch):
    """A --config line reaches run_iterative with its per-stage tools and
    the backend given before --config."""
    seen = {}

    def fake_run(seq, out, iters, temp, type_, backend, extra, keep,
                 tree_tool="auto", init_tool=None, iter_tool=None,
                 final_tool=None):
        seen.update(seq=seq, iters=iters, backend=backend, init=init_tool,
                    it=iter_tool, fin=final_tool, keep=keep)

    monkeypatch.setattr(iterative, "run_iterative", fake_run)
    rc = iterative.main(["--backend", "native", "--config", "TYPE=n",
                         "SEQ=in.fa", f"OUT={tmp_path}/o.aln", "ITER=2",
                         "INITTREE=dipper", "ITERTREE=fasttree",
                         "FINALTREE=iqtree", "KEEP=yes"])
    assert rc == 0
    assert seen == {"seq": "in.fa", "iters": 2, "backend": "native",
                    "init": "dipper", "it": "fasttree", "fin": "iqtree",
                    "keep": True}


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["twilight_tpu_torch.workflow",
                                    "twilight_tpu_torch.workflow.iterative"])
@pytest.mark.parametrize("args,rc", [(["--help"], 0), ([], 2)],
                         ids=["help", "no-args"])
def test_python_m_workflow(module, args, rc):
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == rc
    if rc == 0:
        assert "twilight-tpu-torch-workflow" in r.stdout
        assert "{auto,cuda,cpu,native,numpy}" in r.stdout
    else:
        assert "required" in r.stderr


@pytest.mark.parametrize("mode", ["iterative", "placement"])
def test_auto_backend_without_a_card_exits_1(tmp_path, monkeypatch, capsys,
                                             mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.aln"
    argv = ["-i", os.path.join(DATA, "prot_16.fa"), "-o", str(out)]
    if mode == "placement":
        argv += ["-a", os.path.join(DATA, "prot_16.fa")]
    assert iterative.main(argv) == 1
    err = capsys.readouterr().err
    assert "--backend auto found no CUDA device" in err
    assert "--backend native" in err
    assert not out.exists()
    assert not os.path.exists(str(tmp_path / "o_iter"))


@pytest.mark.parametrize("type_", ["n", "p"])
def test_sp_score_equals_jax(tmp_path, capsys, type_):
    if type_ == "p":
        msa = os.path.join(REPO, "tests", "golden", "prot_16.aln")
    else:
        prefix = str(tmp_path / "s")
        assert simulate.main(["-n", "30", "-l", "200", "--seed", "3",
                              "-o", prefix]) == 0
        msa = str(tmp_path / "s.aln")
        assert tpu_cli.main(["-t", prefix + ".nwk", "-i", prefix + ".fa",
                             "-o", msa, "--backend", "native"]) == 0
    rows = [s for _, _, s in iter_fasta(msa)]
    got = sp_score.sp_score(rows, type_, Params.make(type_))
    assert got == tpu_sp_score.sp_score(rows, type_, TpuParams.make(type_))
    capsys.readouterr()
    assert sp_score.main([msa, "--type", type_]) == 0
    line = capsys.readouterr().out
    assert tpu_sp_score.main([msa, "--type", type_]) == 0
    assert line == capsys.readouterr().out
    assert line.startswith(f"rows={len(rows)} ")
