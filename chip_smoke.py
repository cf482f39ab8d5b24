#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (twilight_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the nvcc builds of the kernels (one a source, in parallel,
   with the probes' barrier-exchange build beside them), timed; each TALCO kernel instance's attributes (registers, local spill
   bytes, static shared bytes, maximum threads) and launch configuration
   (the one every route launches), which must fit the 227 KB opt-in and
   split the rows at talco_cuda.W_S, the split the packer sizes each
   pair's scratch by;
3. kernel parity (`parity`): 212 seeded profile pairs (nucleotide and
   protein, freq and leaf routes, weighted profiles with gap rows,
   gap_char 0, marker 1024 and 64, lengths 30-2048, unrelated pairs giving
   errors 1 and 2), and 28 freq pairs at tasks 0 and 3 whose sides stand
   for 10000-22135 sequences (SCALE_COUNTS: products and ref_num *
   qry_num past 2^24, gap_char 0 above 10000), through the CUDA kernel,
   held byte-for-byte against the NumPy oracle (talco_np.align_freq) and
   against the kernel's plain PyTorch version on CPU tensors;
4. long parity (`long_parity`, the route of the TPU's K4, and of K5 above
   padlen 32768): 68 pairs of 2049-6000 columns, 5 of 25-31 kb and 6 of
   40-70 kb (padlen past 65536), nt and protein, freq and leaf, and 14
   pairs of 2600-4000 columns at X-drop 60000 and marker 8192 whose
   one-tile band provably crosses W_S (rows past it in scratch), and 19
   freq pairs of 2049-6000 and 13000-20600 columns whose sides stand for
   10000-22135 sequences (as in the parity phase), in
   launches cut and padded as the batcher cuts them, held byte for byte
   against the native host kernel (bit-equal to the oracle by the repo's
   own tests), those up to 3000 columns also against the plain version;
5. wide parity (`wide`, the work of the TPU's K5): 16 pairs whose X-drop
   band outgrows ladder width 4096 (error 2) and fits at 8192 or 16384,
   held to the native host kernel at both widths; the wide launch is
   timed, and the plain version timed on one wide pair;
6. kernel time at the main path's shapes (`time`, batch 128, padlen
   2048): nt freq, nt leaf, protein freq and protein leaf, ms/pair with
   H2D + kernel + D2H and resident and us per diagonal, beside the plain
   version's time on CUDA tensors for 1 of the pairs;
7. long time (`long_time`): nt freq and nt leaf at 29-30 kb, protein freq
   at 2.9-3 kb, each at the launch size the batcher picks, with DP
   Gcells/s, and the plain version's time for one ~3000-column pair;
8. end to end through the port's entry point (`e2e`;
   `twilight_tpu_torch.cli`, which `python -m twilight_tpu_torch` runs)
   with --backend cuda, the device forced and no host stealing: prot_16
   and sim2k (2000 x 1 kb simulated, --rooted) must give their golden
   md5s with every non-empty pair resolved on the device; sim2k also runs
   on the native host kernel for the wall-time comparison, forced with
   host stealing on, and as a user runs it by default (not forced: the
   level-size gate picks host or device per level, and host threads
   steal), each with the same md5 and its launch count printed, and with
   no --backend flag at all (the default, auto: must launch). Forced
   device runs of sim2k with --length-deviation 0.02 (706 sequences
   realigned at task 1, where errors 1/2 take the retry ladder) and of 8
   divergent 2 kb sequences (wide X-drop bands) must give the pinned md5
   and the native host kernel's md5;
9. long end to end (`long_e2e`), device forced, each md5-equal to
   --backend native in the same process: 20 x 30 kb nt (the sars_20
   shape, pinned md5) and 12 x 3 kb protein (pinned md5), every
   non-empty pair on the device in long launches; and the 30 kb set with
   one sequence replaced by an unrelated 5 kb one (--length-deviation
   0.1), whose deferred realignment climbs the retry ladder into wide
   launches;
10. launch round trip (`gate`): 8 nt pairs of 100 columns through the
   batcher (pack into pinned staging, H2D, kernel, D2H, the event's
   wait), the median of 50 by the host clock, the figure behind the level
   gate of pipeline/aligner.py; the unforced sim2k run of phase 8 must
   make at least one launch through that gate;
11. loop-cost probes (`probes`, K6-K10): the 9 variants of
   ops/csrc/probe_loop_costs.cu, each as one block and as one cluster of
   8 CTAs (a group row a CTA), at 2, 6 and 40 trips, bit-equal to their
   plain versions on CUDA tensors (NaN positions included), in both
   layouts also with the initial state's offset, which makes a wrong
   roll, a skipped exchange or a row written in another's place change
   the result (and body/scratch then finite), each cluster instance
   bit-equal to its one-block instance at 4000 trips, with each
   instance's registers, local spill bytes, threads, cluster size and
   resident clusters (a cluster instance: no local bytes); deadcode and
   nested+walk in both layouts with live walks (2 trips, the offset,
   walk_floor 4096: the exchange that starts them is then seen),
   bit-equal to their plain versions, whose walks emit; then the port's
   probe tool (tools/probe_loop_costs.py) times each instance in ns/step
   with the launch counts zeroed just before and read just after, and
   the plain versions are timed per step. Last, the build whose
   scalar0d/body and /both exchange at a cluster barrier
   (-DPROBE_CLUSTER_EXCHANGE=1, built with the others) is held to the
   same checks and timed beside the default.
12. workflow (`workflow`): `python -m twilight_tpu_torch.workflow`'s
   iterative mode (run_iterative, what its main runs) on sim10k (10000 x
   1 kb), 2 iterations, default backend: each step's wall (k-mer, Gram on
   the host, NJ/PartTree, alignment 0, msa distances, NJ, alignment 1),
   the launches of each alignment and one count product on the card;
   its iter0.nwk, iter1.nwk and final md5 must equal those of the whole
   workflow with --backend native (GOLDEN_WF10K_*, recorded on the H100's
   host) (SP score printed); and what a fresh DP batcher costs an
   iteration;
13. products (`products`): the msa counts of the workflow's iter0.aln and
   placement's counts of 5000 x 5000 rows of its final MSA, each on the
   card (resident, with copies, the copies alone) against the host NumPy
   route, with its bound, bit-equal; TF32 off inside the products; and
   the round trip of pair_counts_on on a small block (the gate's figure);
14. placement (`placement`): 2000 simulated 1 kb rows aligned on the card
   with their pruned true tree, 500 more placed with `-t` that tree and
   `-n 2` through the workflow's main with the default backend,
   md5-equal to --backend native;
15. multihost (`multihost`): sim10k with its true tree, --rooted -m
   2000, --backend cuda, as two processes on this card in a
   torch.distributed gloo group (no host flags), the subtree states
   exchanged by all-gather: each process's subtrees, wall and launches
   (both must launch), host 1 writes no output, host 0's md5 equals a
   one-process --backend native run's with the same -m (pinned);
16. multidevice (`multidevice`): sim2k with the device forced through
   DeviceTalco(devices=[cuda:0, cuda:0]) (two launch queues, each with
   its stream and matrix copy) in turns with one queue: the golden md5,
   launches split over both queues, the walls side by side;
17. fuzz (`fuzz`): the kernel fuzz (tools/fuzz_talco.py) with a seed of
   its own (FUZZ_SEED): 128 short pairs (nt and protein, freq and leaf, 32
   each, 8 of them at marker 64) held to the NumPy oracle, 32 long pairs
   (2049-32768 columns) and 8 wide freq pairs (each at width 4096 and at
   8192 or 16384) held to the native host kernel; none may differ, and
   errors 1 and 2 must both be seen;
18. bench (`bench`): the kernel bench (tools/bench_kernel.py) on short nt
   freq (batch 128, 1700 columns), nt leaf, protein freq, long nt freq (30
   kb) and wide nt freq: pairs/s with copies, ms/pair resident, us per
   diagonal, bound and its share, each with the card's name and power
   limit, and us per diagonal beside PERF.md section 6's (a print);
19. quality (`quality`): the quality harness (tools/quality_harness.py)
   at sim2k's shape (-n 2000 -l 1000 --seed 2) with --backend cuda and
   --backend native as two processes side by side, started after the wide
   phase so that they run beside the dry run and the parity, long parity
   and fuzz phases' host references (which time nothing): SP per pair of
   each strategy
   (true tree, placement with the tree, grafting, iterative), every output
   md5-equal between the two, the cuda run launching;
20. front door (`frontdoor`): prot_16 with --backend native through
   `python -m twilight_tpu_torch` as it runs, with torch refused and with
   torch imported first (timing the import), in turns, each its golden
   md5; -h with torch refused;
21. SASS census (`census`, right after the build; tools/sass_census.py):
   the instruction mix by class of the 4 TALCO instances, the 9 one-block
   probe variants and the 9 cluster instances from cuobjdump -sass of the
   built libraries; every instance must be there, one whose
   cudaFuncGetAttributes local size is 0 must show no LDL/STL, no probe
   instance an FFMA, no cluster instance local bytes; each TALCO
   instance's FFMA count is printed with its source (not a check);
22. graft entry (`entry`; graft_entry.py): entry() on cuda:0, one launch
   of the TALCO step, held to the plain version on the same CUDA tensors
   and to the oracle, its resident time printed; then the sharded kernel
   (parallel/sharding.py) over [cuda:0, cuda:0] on 8 pairs, one launch a
   shard, held to the oracle;
23. dry run (`dryrun`; graft_entry.dryrun_multichip(2)): the production
   batcher over two distinct cards when the machine has them, else over
   [cuda:0, cuda:0], host stealing off, through the short freq, leaf,
   long and wide (ladder) routes, every pair byte-equal to the oracle
   (computed on the host pool while the card runs), every queue
   launching; the batcher's stats line printed;
24. resume (`resume`): checkpoint/resume of divide-and-conquer, sim10k
   --rooted -m 2000 with the device forced, in this process: a -k run
   (md5 of one native process, one state checkpoint a subtree), its
   --resume --overwrite rerun (the same md5, every subtree resumed, only
   the meta-tree merge's pairs launched), a --resume run without -k whose
   update_and_write_alignment raises on its second call (the error comes
   up, every unexpanded subalignment stays) and its --overwrite rerun
   (every subtree resumed, the same md5);
25. merge (`merge`): merge mode (-f) over the first resume run's
   subalignments (one MSA of ~2000 rows a subtree), the device forced,
   md5-equal to --backend native in this process;
26. cross-level (`crosslevel`, TWILIGHT_CROSS_LEVEL=1): sim2k --rooted
   forced (with TWILIGHT_PROFILE: the batcher's call lines printed, and
   the rounds counted), with no --backend flag, with --length-deviation
   0.02 forced, and forced over two queues of cuda:0, each held to its
   golden md5, each launching (both queues), each printed beside the e2e
   phase's per-level run of the same flags;
27. scale (`scale`): sim40k (40000 x 1 kb, true tree) --rooted -m 20000,
   three subtrees of 10499-17865 sequences at 13-15k columns and a
   meta-tree merge whose sides pass 10000 sequences, 20587 columns in all,
   through the entry point in this process: forced onto the card with no
   stealing (md5 GOLDEN_SIM40K, every non-empty pair on the card or
   deferred at task 0, pairs packed with a side above 10000
   sequences counted through a wrapped pack_batch, each with gap_char 0;
   its DP sides stay within 2048 columns, since the gappy columns are
   removed first, so it makes no long launch), then as a user runs it (no
   --backend flag, no knobs; the same md5); each run's wall, launches by
   route, stolen pairs, peak device memory, RSS, subtrees, widths and
   output bytes printed, the output deleted once its md5 is taken;
28. protein (`protein`): the protein path at a protein user's sizes,
   every run held to a recorded md5 (no native process): prot20k (20000
   x ~400 residues, true tree) --type p --rooted -m 10000 (3 subtrees,
   a meta-tree merge with a side above 10000 sequences), forced with no
   stealing as the scale phase holds sim40k, and also held to launches
   of both protein instances (talco_xdrop_kernel<22, true> and <22,
   false>, counted by the wrapper), then with no --backend flag; the
   workflow's iterative mode on prot5k (5000 x ~400, --type p, two
   iterations, default backend: iter0.nwk, iter1.nwk and the final md5
   the native workflow's, one protein count product on the card, its
   letters, one-hot bytes and peak device memory printed); prot_16 forced
   with -b 45 and -b 80 (the reference goldens) and with two -x files:
   BLOSUM62 as -b 62 scores it, and a changed matrix in another letter
   order; then one [protein] summary line;
29. protein_trace (`protein_trace`, only when --only names it): prot20k
   forced under a torch.profiler trace (the CLI's --profile-trace; the
   same md5, every launch seen in the trace): the TALCO kernels' device
   time, the copies', and the card's busy time and idle share;
30. scale_r1 (`scale_r1`, only when --only names it): sim40k forced with
   -r 1 (no column removed: long and wide launches up to padlen 9728,
   pairs of a side above 10000 sequences among them; md5
   GOLDEN_SIM40K_R1, both packages' native md5);
31. scale100k (`scale100k`, only when --only names it): the forced and
   the default run on sim100k (100000 x 1 kb, 7 subtrees, 28567 columns,
   a 2.86 GB output), md5 GOLDEN_SIM100K.

`--only a,b,...` runs some phases (build always runs; products needs
workflow, merge needs resume; protein_trace, scale_r1 and scale100k
run only when named) and prints no kernels line. Each phase's wall is
printed ([timing]).

Only the port is imported (twilight_tpu_torch); its simulator makes the
sets, and the inputs, launches, host references and bounds of the kernel
phases are its tools' (tools/talco_inputs.py). The products' figures are a
JSON line of their own. The last two lines are a JSON object with the
kernels' figures (K1/K2, K4, K5, the protein instances of K1 and K2,
K6-K10, K8 and K10 in both layouts: time, plain time, bound, launches)
and the result line {"ok": true, "device": {...}}. Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero.
"""
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GOLDEN_SIM2K = "624c589fc0fab056e15b3b88047eddf6"
GOLDEN_PROT16 = "8174145594cfcd5404008e233e10ea30"
# sim2k --rooted --length-deviation 0.02 (tests/test_deferred_realign.py)
GOLDEN_SIM2K_DEFER = "224c800d696d24cac399a1630747c39a"
GOLDEN_S20 = "36d57b4abdd43021ec64b58c40be48be"   # simulate -n 20 -l 30000
GOLDEN_P12 = "f800c5b151b27b3e47881b1865b46a18"   # --type p -n 12 -l 3000
# sim10k --rooted -m 2000 --backend native in one process (the H100's host
# in every call since it was first run, and a CPU host)
GOLDEN_MULTIHOST = "5241d7948d7fc8f4acca92ff7f6608dd"
# simulate -n 40000 -l 1000 --seed 0, then --rooted -m 20000 -d <fresh dir>
# --backend native: python -m twilight_tpu_torch and python -m
# twilight_tpu give it alike (3 subtrees, 40000 x 20587 columns)
GOLDEN_SIM40K = "b340ec564d709a48f40057974be84212"
# the same with -r 1 (no gappy column removed before the DP; 40000 x 10235
# columns), both packages alike
GOLDEN_SIM40K_R1 = "a7b4709bb51a9f6bf5202fc8f7eca757"
# python -m twilight_tpu_torch.workflow's iterative mode on sim10k, two
# iterations, --backend native (the H100's host): iter0.nwk and iter1.nwk
# (md5 of the text without its closing newline) and the final MSA; the
# default backend's run must give the same bytes
GOLDEN_WF10K_TREE0 = "205b2b6eaf8368788995498902130863"
GOLDEN_WF10K_TREE1 = "4a9af4ee9fd0547466ceafa485264fe4"
GOLDEN_WF10K = "622070070421035d02b9598b3e642396"
# the same with -n 100000 (7 subtrees, 100000 x 28567 columns)
GOLDEN_SIM100K = "573154ec7f3c37edc752c76e90863493"
# the protein phase. simulate --type p -n 20000 -l 400 --seed 0, then
# --type p --rooted -m 10000 -d <fresh dir> --backend native: python -m
# twilight_tpu_torch and python -m twilight_tpu give it alike (3 subtrees,
# 20000 x 7379 columns)
GOLDEN_PROT20K = "0e5ebc1b6795b7ba36d4c0a5eb5029f5"
# python -m twilight_tpu_torch.workflow's iterative mode on prot5k
# (simulate --type p -n 5000 -l 400 --seed 0), --type p, two iterations,
# --backend native on the H100's host: iter0.nwk, iter1.nwk (as
# GOLDEN_WF10K_*) and the final MSA, twilight_tpu.workflow's alike. A host
# whose BLAS rounds the k-mer Gram product otherwise writes another
# iter0.nwk (c9bcc996... on a CPU host), with the same iter1.nwk and MSA
GOLDEN_WFP5K_TREE0 = "4533c8b0b0eae8d012f76f1eb44ac03b"
GOLDEN_WFP5K_TREE1 = "b6850003d26b287ba2d3bffd72c17797"
GOLDEN_WFP5K = "b35eb89e07ac0defe10c78ffd84b66e9"
# prot_16 with -b 45 and -b 80: the reference TWILIGHT's outputs
# (tests/golden/prot_16.b45.aln, prot_16.b80.aln)
GOLDEN_PROT16_B45 = "9af2a23685daa29d8e9fdeee7d77c534"
GOLDEN_PROT16_B80 = "fa2b46e93a6a20121609bbe7179e3163"
# prot_16 with -x: BLOSUM62 (x 5, as -b 62 scores it) written out over its
# 20 letters gives GOLDEN_PROT16 itself; the changed matrix
# (changed_blosum62) gives this, with --backend native of both packages
GOLDEN_PROT16_XCHANGED = "ddcade90d4fbb8b244b5ef3fb66f4241"
KERNEL_SOURCE = "twilight_tpu_torch/ops/csrc/talco_xdrop.cu"
REPLACES = "twilight_tpu/ops/talco_pallas_g8.py:1672"
REPLACES_LONG = "twilight_tpu/ops/talco_pallas_g8.py:1556"   # hbm_in
REPLACES_WIDE = "twilight_tpu/ops/talco_pallas.py:579"
# sides' counts of the parity phases' scaled freq pairs: the exact
# boundary of gap_char 0 (10000 / 10001) and sim40k's subtree sizes and
# their sums, whose products and den (ref_num * qry_num) pass 2^24 and
# round in f32
SCALE_COUNTS = ((10000, 10001), (10001, 10000), (10000, 10000),
                (17865, 22135), (22135, 17865), (10499, 11636))
# (p, leaf, marker, task, pairs, max length, scaled): the parity phase's
SCALED_SHORT = [(6, False, 1024, 0, 12, 1200, True),
                (6, False, 1024, 3, 6, 1200, True),
                (22, False, 1024, 0, 6, 600, True),
                (22, False, 1024, 3, 4, 600, True)]
# (p, leaf, task, pairs, min length, max length, scaled): long parity's,
# up to sim40k's 13-20k-column subtree and meta-tree widths
SCALED_LONG = [(6, False, 0, 6, 2100, 6000, True),
               (6, False, 3, 4, 2100, 3000, True),
               (22, False, 0, 3, 2100, 3000, True),
               (6, False, 0, 6, 13000, 20600, True)]
PLAIN_SUBSET = 1              # pairs timed through the plain version
PLAIN_MAX_COLS = 3000         # long pairs also held to the plain version
LONG_PLAIN_PAIRS = 12         # at most this many of them
SCALED_LONG_PLAIN = 4         # and of SCALED_LONG's
PROBE_PLAIN_TRIPS = (20, 200)  # the plain probes' per-step time
PROBE_AB_TRIPS = 4000          # a cluster instance against one block
PROBE_LIVE_WALK_FLOOR = 4096   # above every row maximum at 2 trips
PROBE_SOURCE = "twilight_tpu_torch/ops/csrc/probe_loop_costs.cu"
SIM2K = ("sim2k", "-n", "2000", "-l", "1000", "--seed", "0")
SIM10K = ("sim10k", "-n", "10000", "-l", "1000", "--seed", "0")
# the scale phases' sets (README's scale runs), each --rooted -m SCALE_M
SIM40K = ("sim40k", "-n", "40000", "-l", "1000", "--seed", "0")
SIM100K = ("sim100k", "-n", "100000", "-l", "1000", "--seed", "0")
SCALE_M = 20000
PROT20K = ("prot20k", "--type", "p", "-n", "20000", "-l", "400", "--seed",
           "0")
PROT_M = 10000                # prot20k's -m: 3 subtrees, a side above 10000
PROT5K = ("prot5k", "--type", "p", "-n", "5000", "-l", "400", "--seed", "0")
AA20 = "ACDEFGHIKLMNPQRSTVWY"   # a -x file's letters, in the port's order
XCHANGED_ORDER = "WYFMLIVCAGPSTNDEQKRH"   # the changed matrix's
MULTIHOST_M = 2000            # the multihost phase's -m (sim10k: 2000 max)
PROC_TIMEOUT_S = 600          # each process of the multihost phase
PLACE_ROWS = 5000             # placement counts: 5000 x 5000 rows
PLACE_N, PLACE_BACKBONE = 2500, 2000   # placement mode: 2000 + 500
PRODUCT_REPS = 3              # card routes timed by the host clock
FUZZ_SEED = 20261019          # the fuzz phase's seed (the parity phases':
                              # 20261016-20261018)
# the fuzz phase's runs: (route, pairs a path and mode, marker)
FUZZ_RUNS = [("short", 24, 1024), ("short", 8, 64), ("long", 8, 1024),
             ("wide", 4, 1024)]
# the bench phase's launches: (label, bench_kernel.bench arguments)
BENCH_RUNS = [("short nt freq", {}), ("short nt leaf", {"leaf": True}),
              ("short protein freq", {"protein": True}),
              ("long nt freq", {"route": "long"}),
              ("wide nt freq", {"route": "wide"})]
# us per diagonal of the same routes in PERF.md section 6 (review run, PR
# 4; NVIDIA H100 80GB HBM3, 700 W), printed beside the bench's
PERF_US_PER_DIAG = {"short nt freq": 1.917, "short nt leaf": 1.144,
                    "short protein freq": 4.675, "long nt freq": 2.121,
                    "wide nt freq": 8.238}
QUALITY_ARGS = ("-n", "2000", "-l", "1000", "--seed", "2")   # sim2k's shape
FRONTDOOR_REPS = 2
# a fresh interpreter in which importing torch raises (a meta-path finder
# refuses it and records each attempt) runs `python -m twilight_tpu_torch`
# with the arguments after the code
NO_TORCH = r"""
import atexit, importlib.abc, runpy, sys
attempts = []

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "torch":
            attempts.append(name)
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
atexit.register(lambda: print("TORCH_ATTEMPTS", attempts, file=sys.stderr))
sys.argv = ["twilight_tpu_torch"] + sys.argv[1:]
runpy.run_module("twilight_tpu_torch", run_name="__main__", alter_sys=True)
"""
# the same with torch imported first, as every run imported it before the
# front door; prints the import's time
TORCH_FIRST = r"""
import runpy, sys, time
t0 = time.perf_counter()
import torch
print("IMPORT_TORCH_S", time.perf_counter() - t0, file=sys.stderr)
sys.argv = ["twilight_tpu_torch"] + sys.argv[1:]
runpy.run_module("twilight_tpu_torch", run_name="__main__", alter_sys=True)
"""
# the probe kernels (K6-K10): wrapper, replaced pallas_call, the variant
# whose time is the kernel's "ms", f32 operations per loop step, layout
# (the cluster instance, then the one-block one)
GRP_W = 8 * 640
PROBES = [
    ("carcass", "K6", "tools/probe_loop_costs.py:86", "carcass",
     8 * GRP_W + 20 * 8, "cluster"),
    ("carcass", "K6", "tools/probe_loop_costs.py:86", "carcass",
     8 * GRP_W + 20 * 8, "block"),
    ("body", "K7", "tools/probe_loop_costs.py:144", "body/carried",
     37 * GRP_W + 8, "cluster"),
    ("body", "K7", "tools/probe_loop_costs.py:144", "body/carried",
     37 * GRP_W + 8, "block"),
    ("scalar0d", "K8", "tools/probe_loop_costs.py:239", "scalar0d/both",
     41 * GRP_W + 8, "cluster"),
    ("scalar0d", "K8", "tools/probe_loop_costs.py:239", "scalar0d/both",
     41 * GRP_W + 8, "block"),
    ("deadcode", "K9", "tools/probe_loop_costs.py:317", "deadcode",
     37 * GRP_W + 8, "cluster"),
    ("deadcode", "K9", "tools/probe_loop_costs.py:317", "deadcode",
     37 * GRP_W + 8, "block"),
    ("nested", "K10", "tools/probe_loop_costs.py:391", "nested",
     37 * GRP_W + 8, "cluster"),
    ("nested", "K10", "tools/probe_loop_costs.py:391", "nested",
     37 * GRP_W + 8, "block"),
]
class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """The attributes of each kernel instance (cudaFuncGetAttributes:
    registers, local spill bytes, static shared bytes, maximum threads),
    and its launch configuration, the same on every route (short, long and
    wide launches): it must fit the instance's limits and the 227 KB
    opt-in, keep the rows of offsets below talco_cuda.W_S in shared memory
    (pair_scratch_bytes sizes the rest in scratch) and hold MAX_WINDOW;
    and the blocks of it the card holds at once, at least one an SM."""
    import torch
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    out = {}
    for p in (6, 22):
        msize = Params.make("n" if p == 6 else "p").matrix_size
        for leaf in (False, True):
            name = f"talco_xdrop_kernel<{p}, {str(leaf).lower()}>"
            lib = talco_cuda.launch_config(leaf, talco_cuda.MARKER, msize)
            attr = talco_cuda.kernel_attributes(p, leaf)
            threads = lib["consumers"] + lib["producers"]
            check(lib["smem_bytes"] <= attr["max_dynamic_shared_bytes"]
                  and lib["smem_bytes"] <= lib["smem_limit"] == 232448
                  and threads <= attr["max_threads_per_block"],
                  f"build/{name}: a launch needs {lib['smem_bytes']} bytes "
                  f"and {threads} threads")
            ring_ok = (lib["ring_cells"] == 0 if leaf
                       else lib["ring_cells"] >= 960)
            check(lib["w_s"] == talco_cuda.W_S
                  and lib["max_width"] == talco_cuda.MAX_WINDOW and ring_ok,
                  f"build/{name}: launch configuration {lib}")
            attr["launch"] = {k: lib[k] for k in (
                "consumers", "producers", "smem_bytes", "ring_cells")}
            # the batcher's long launches fill this side by side
            attr["resident_blocks"] = talco_cuda.resident_blocks(
                p, leaf, "cuda", msize)
            check(attr["resident_blocks"]
                  >= torch.cuda.get_device_properties(0)
                  .multi_processor_count,
                  f"build/{name}: fewer resident blocks than SMs")
            out[name] = attr
            print(f"[build] {name}: " + json.dumps(attr), flush=True)
    return out


def phase_parity(torch, mp_pool, workers):
    import numpy as np
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    from twilight_tpu_torch.tools.talco_inputs import make_pair, pack
    from twilight_tpu_torch.tools import talco_inputs as ti
    rng = np.random.default_rng(20261016)
    # (p, leaf, marker, task, pairs, max length, sides' counts)
    groups = [(6, False, 1024, 0, 30, 2048), (6, False, 1024, 1, 14, 2048),
              (6, False, 64, 0, 12, 600), (6, True, 1024, 0, 40, 2048),
              (6, True, 64, 0, 12, 600), (22, False, 1024, 0, 30, 2048),
              (22, False, 1024, 1, 10, 1200), (22, False, 64, 0, 12, 600),
              (22, True, 1024, 0, 40, 2048), (22, True, 64, 0, 12, 600)]
    groups = [g + (False,) for g in groups] + SCALED_SHORT
    launches0 = talco_cuda.talco_align.launches
    jobs, kern = [], []
    for p, leaf, marker, task, n, maxlen, scaled in groups:
        param = Params.make("n" if p == 6 else "p")
        prepared, metas, flen, xdrop = [], [], [], []
        for t in range(n):
            length = int(np.exp(rng.uniform(np.log(30), np.log(maxlen))))
            kind = t % 10
            prep, meta = make_pair(
                rng, p, leaf, length, related=kind not in (3, 7),
                counts=SCALE_COUNTS[t % len(SCALE_COUNTS)] if scaled
                else None)
            prepared.append(prep)
            metas.append(meta)
            # unrelated pairs with a tight X-drop collapse the band (error
            # 1); a narrow ladder width overflows it (error 2)
            xdrop.append(int(rng.integers(60, 200)) if kind == 3 else 5000)
            flen.append(int(rng.integers(4, 24)) if kind == 7 else 4096)
        st = pack(list(range(n)), prepared, metas, task, p, leaf, param,
                  flen, xdrop, marker)
        paths, tail = ti.launch(torch, st, p, marker)
        for i in range(n):
            jobs.append({"p": p, "leaf": leaf, "marker": marker,
                         "task": task, "prep": prepared[i], "meta": metas[i],
                         "flen": flen[i], "xdrop": xdrop[i], "plain": True})
            kern.append((paths[i, :tail[i, 0]].copy(), tail[i].copy(),
                         (p, leaf, marker, task, metas[i][2:])))
    launched = talco_cuda.talco_align.launches - launches0
    check(launched == len(groups),
          f"parity: launch counter advanced {launched}, expected "
          f"{len(groups)}")
    t0 = time.time()
    refs = ti.host_refs(mp_pool, jobs)
    bad, max_err, errs, _ = ti.hold(kern, refs, "parity")
    print(f"[parity] {len(jobs)} pairs in {len(groups)} launches; error "
          f"codes {dict(sorted(errs.items()))}; oracle + plain version on "
          f"{workers} CPU workers in {time.time() - t0:.1f} s; "
          f"mismatches {bad}; max |kernel - oracle or plain| {max_err} "
          "(tolerance 0: "
          "paths byte-equal, tails equal)", flush=True)
    check(bad == 0, f"parity: {bad} of {len(jobs)} pairs differ")
    check(len(jobs) >= 200, "parity: fewer than 200 pairs")
    check(errs.get(1, 0) > 0 and errs.get(2, 0) > 0,
          "parity: errors 1 and 2 were not both exercised")
    _scaled_summary("parity", jobs, 16)
    return max_err


def _scaled_summary(label, jobs, want):
    """Prints the held pairs whose sides stand for thousands of
    sequences (SCALE_COUNTS): how many, how many of them with a side above
    10000 (gap_char 0 in the packer and the host references), the largest
    ref_num * qry_num; at least `want` must have a side above 10000."""
    big = [j for j in jobs if max(j["meta"][2:4]) >= 10000]
    zero = sum(max(j["meta"][2:4]) > 10000 for j in big)
    prod = max((j["meta"][2] * j["meta"][3] for j in big), default=0)
    print(f"[{label}] {len(big)} pairs of sides counting "
          f"{sorted({c for j in big for c in j['meta'][2:4]})} sequences, "
          f"{zero} with gap_char 0 (a side above 10000), largest "
          f"ref_num * qry_num {prod} (2^24 = {1 << 24})", flush=True)
    check(zero >= want and prod > 1 << 24,
          f"{label}: {zero} pairs with a side above 10000 sequences "
          f"(want {want}), largest product {prod}")


def phase_time(torch):
    """Kernel time at the main path's shapes."""
    import numpy as np
    from twilight_tpu_torch.ops.device_kernel import Params
    from twilight_tpu_torch.tools.talco_inputs import make_pair, pack
    from twilight_tpu_torch.tools import talco_inputs as ti
    rng = np.random.default_rng(7)
    shapes = [("nt freq", 6, False, 900, 1200), ("nt leaf", 6, True, 900,
                                                 1200),
              ("protein freq", 22, False, 250, 450),
              ("protein leaf", 22, True, 250, 450)]
    out = {}
    for name, p, leaf, lo, hi in shapes:
        param = Params.make("n" if p == 6 else "p")
        b = 128
        prepared, metas = zip(*[make_pair(rng, p, leaf,
                                          int(rng.integers(lo, hi)))
                                for _ in range(b)])
        flen = [4096] * b
        xdrop = [5000] * b
        st = pack(list(range(b)), prepared, metas, 0, p, leaf, param, flen,
                  xdrop, 1024, pin=True)
        prod, resid, paths, tail = ti.launch_times(torch, st, p, b, 2048, 5)
        check((tail[:, 1] == 0).all(),
              f"time/{name}: kernel errors {np.unique(tail[:, 1])}")
        # the plain version on CUDA tensors, for the first pairs
        sub = pack(list(range(PLAIN_SUBSET)), prepared, metas, 0, p, leaf,
                   param, flen, xdrop, 1024)
        plain_ms = _plain_ms(torch, sub, p, paths, tail, f"time/{name}")
        cells = int(tail[:, 2].astype(np.int64).sum())
        diags = int(tail[:, 3].astype(np.int64).sum())
        res = {"ms_per_pair_h2d_kernel_d2h": prod / b,
               "ms_per_pair_resident": resid / b,
               "ms_per_launch_resident": resid,
               "plain_ms_per_pair": plain_ms,
               "plain_subset_pairs": PLAIN_SUBSET,
               "dp_cells": cells, "diagonals": diags,
               "max_diagonals_per_pair": int(tail[:, 3].max()),
               "us_per_diagonal": 1e3 * resid / int(tail[:, 3].max()),
               "gcells_per_s_resident": cells / (resid * 1e6),
               "h2d_bytes": int(st.buf.numel())}
        ti.talco_bound(res, name, b, 2048)
        out[name] = res
        print(f"[time] {name} batch {b} padlen 2048: "
              + json.dumps(res), flush=True)
    return out


def _crosses_w_s(tail, lens):
    """Whether a pair's X-drop band provably passed W_S offsets on some
    diagonal: more cells than diagonals of at most W_S cells can hold
    (for a pair aligned in one tile, each diagonal also capped by the
    DP triangle)."""
    from twilight_tpu_torch.ops.talco_cuda import W_S
    err, cells, diags = int(tail[1]), int(tail[2]), int(tail[3])
    rl, ql = lens
    if err != 0:
        return False
    if diags == rl + ql - 1:
        cap = sum(min(k + 1, rl, ql, rl + ql - 1 - k, W_S)
                  for k in range(diags))
    else:
        cap = W_S * diags
    return cells > cap


def phase_long_parity(torch, mp_pool, workers):
    """The long route (the TPU's K4, and K5 above padlen 32768): pairs of
    2049-6000 columns, of 25-31 kb and of 40-70 kb (launch padlen past
    65536), nt and protein, freq and leaf, in launches cut and padded as
    the batcher cuts them, held byte for byte against the native host
    kernel, and those up to PLAIN_MAX_COLS columns also against the plain
    version."""
    import numpy as np
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    from twilight_tpu_torch.tools.talco_inputs import WIDE_XDROP, pack
    from twilight_tpu_torch.tools import talco_inputs as ti
    rng = np.random.default_rng(20261017)
    # (p, leaf, task, pairs, min length, max length)
    groups = [(6, False, 0, 20, 2100, 6000), (6, False, 1, 8, 2100, 6000),
              (6, True, 0, 20, 2100, 6000), (22, False, 0, 12, 2100, 6000),
              (22, True, 0, 8, 2100, 6000), (6, False, 0, 2, 25000, 31000),
              (6, True, 0, 2, 25000, 31000), (22, False, 0, 1, 25000, 31000),
              (6, False, 0, 2, 66000, 70000), (6, True, 0, 2, 66000, 70000),
              (6, False, 1, 1, 40000, 45000), (22, False, 0, 1, 40000, 45000)]
    # bands that cross W_S (rows past it live in the pair's scratch):
    # 2600-4000 columns at the raised X-drop, all related, with a marker
    # past the pair's diagonals, so that each is one tile whose band grows
    # past W_S (provably so from its cells: _crosses_w_s)
    crossing = [(6, False, 0, 6, 2600, 4000), (6, True, 0, 4, 2600, 4000),
                (22, False, 0, 4, 2600, 3600)]
    cross_marker = 8192
    groups = [g + (False,) for g in groups + crossing]
    n_plain = len(groups) - len(crossing)
    launches0 = talco_cuda.talco_align.launches
    jobs, kern, padlens = [], [], []
    plain_left = {False: LONG_PLAIN_PAIRS, True: SCALED_LONG_PLAIN}
    t0 = time.time()
    for g, (p, leaf, task, n, lo, hi, scaled) in enumerate(
            groups + SCALED_LONG):
        cross = n_plain <= g < len(groups)
        marker = cross_marker if cross else 1024
        param = Params.make("n" if p == 6 else "p")
        prepared, metas, flen, xdrop = [], [], [], []
        for t in range(n):
            kind = 0 if cross else t % 10
            # unrelated pairs with a tight X-drop collapse the band (error
            # 1); a narrow ladder width overflows it (error 2)
            prep, meta = ti.long_pair(
                rng, p, leaf, lo, hi, related=kind != 3,
                counts=SCALE_COUNTS[t % len(SCALE_COUNTS)] if scaled
                else None)
            prepared.append(prep)
            metas.append(meta)
            xdrop.append(WIDE_XDROP if cross else
                          int(rng.integers(60, 200)) if kind == 3 else 5000)
            flen.append(int(rng.integers(4, 24)) if kind == 7 else 4096)
        idxs = sorted(range(n), key=lambda i: -sum(prepared[i][4]))
        rows, esz = (1, 1) if leaf else (talco_cuda.p8_of(p), 4)
        for chunk, padlen in dk.split_launches(idxs, prepared, flen, rows,
                                               esz, 128, marker=marker):
            st = pack(chunk, prepared, metas, task, p, leaf, param, flen,
                      xdrop, marker, padlen=padlen)
            paths, tail = ti.launch(torch, st, p, marker)
            padlens.append(padlen)
            for bi, i in enumerate(chunk):
                plain = (not cross and max(prepared[i][4]) <= PLAIN_MAX_COLS
                         and plain_left[scaled] > 0)
                plain_left[scaled] -= plain
                jobs.append({"p": p, "leaf": leaf, "marker": marker,
                             "task": task, "prep": prepared[i],
                             "meta": metas[i], "flen": flen[i],
                             "xdrop": xdrop[i], "native": True,
                             "plain": plain, "padlen": padlen})
                kern.append((paths[bi, :tail[bi, 0]].copy(), tail[bi].copy(),
                             (p, leaf, task, prepared[i][4], metas[i][2:])))
    launched = talco_cuda.talco_align.launches - launches0
    t_dev = time.time() - t0
    check(launched == len(padlens),
          f"long parity: launch counter advanced {launched}, expected "
          f"{len(padlens)}")
    t0 = time.time()
    refs = ti.host_refs(mp_pool, jobs)
    bad, max_err, errs, nplain = ti.hold(kern, refs, "long parity")
    lens = [j["prep"][4] for j in jobs]
    n_cross = sum(_crosses_w_s(kt, key[3]) for _, kt, key in kern)
    n_mid = sum(1 for ln in lens if 2048 < max(ln) <= 6200)
    n_big = sum(1 for ln in lens if 24000 <= max(ln) <= 32000)
    n_huge = sum(1 for ln in lens if max(ln) >= 39000)
    print(f"[long parity] {len(jobs)} pairs ({n_mid} of 2049-6000 columns, "
          f"{n_big} of 25-31 kb, {n_huge} of 40-70 kb) in {len(padlens)} "
          f"launches at padlen "
          f"{min(padlens)}-{max(padlens)} ({t_dev:.1f} s with packing); "
          f"error codes {dict(sorted(errs.items()))}; native host kernel "
          f"on all, plain version on {nplain}, {workers} CPU workers in "
          f"{time.time() - t0:.1f} s; mismatches {bad}; max |kernel - "
          "host| "
          f"{max_err} (tolerance 0: paths byte-equal, tails equal); "
          f"{n_cross} pairs whose band crosses W_S", flush=True)
    check(bad == 0, f"long parity: {bad} of {len(jobs)} pairs differ")
    check(n_mid >= 64 and n_big >= 4 and n_huge >= 4,
          f"long parity: {n_mid} mid, {n_big} 25-31 kb and {n_huge} "
          "40-70 kb pairs")
    check(max(padlens) > 65536, f"long parity: no launch past padlen 65536 "
          f"(largest {max(padlens)})")
    check(nplain >= 8, f"long parity: only {nplain} pairs held to the "
          "plain version")
    _scaled_summary("long parity", jobs, 8)
    n_wide = sum(max(j["prep"][4]) > 13000 and max(j["meta"][2:4]) > 10000
                 for j in jobs)
    check(n_wide >= 4, f"long parity: {n_wide} pairs of 13-20k columns "
          "with a side above 10000 sequences (want 4)")
    check(errs.get(1, 0) > 0 and errs.get(2, 0) > 0,
          "long parity: errors 1 and 2 were not both exercised")
    return max_err, n_cross


def _plain_ms(torch, st, p, want_paths, want_tail, label):
    """The plain version's time per pair for the pairs packed in st, on
    CUDA tensors, each held to the kernel's result for it (rows of
    want_paths, want_tail)."""
    import numpy as np
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    mat = torch.from_numpy(
        Params.make("n" if p == 6 else "p").scoring_matrix).cuda()
    sd = st.views(st.buf.to("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp, pt = talco_cuda.talco_align_reference(sd[1], sd[2], sd[3], sd[4],
                                              mat, p=p)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(pt)
    pp, pt = pp.cpu().numpy(), pt.cpu().numpy()
    for i in range(len(pt)):
        n = int(want_tail[i, 0])
        check(np.array_equal(pt[i], want_tail[i])
              and np.array_equal(pp[i, :n], want_paths[i, :n]),
              f"{label}: kernel != plain version on pair {i}")
    return ms


def phase_wide_parity(torch, mp_pool, workers):
    """The wide route (the work of the TPU's K5): pairs of 4300-5200
    columns at a raised X-drop, whose band outgrows the starting ladder
    width 4096 (error 2) and fits at 8192 or 16384. Each runs at both
    widths, held to the native host kernel at the same width; the wide
    launch of the nt pairs is timed, and the plain version's time is
    taken on one of them."""
    import numpy as np
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    from twilight_tpu_torch.tools.talco_inputs import (WIDE_XDROP, make_pair,
                                                       pack)
    from twilight_tpu_torch.tools import talco_inputs as ti
    rng = np.random.default_rng(20261018)
    # (p, task, related pairs, unrelated pairs)
    groups = [(6, 0, 4, 3), (6, 1, 3, 0), (22, 0, 3, 0), (22, 1, 0, 3)]
    launches0 = talco_cuda.talco_align.launches
    nlaunch = 0
    jobs, kern = [], []
    timing = None
    for p, task, n_rel, n_unrel in groups:
        param = Params.make("n" if p == 6 else "p")
        n = n_rel + n_unrel
        prepared, metas = zip(*[
            make_pair(rng, p, False, int(rng.integers(4300, 5200)),
                      related=t < n_rel, cap=6000) for t in range(n)])
        xdrop = [WIDE_XDROP] * n
        wide = [8192 if t % 2 else 16384 for t in range(n)]
        idxs = sorted(range(n), key=lambda i: -sum(prepared[i][4]))
        for flen in ([4096] * n, wide):
            for chunk, padlen in dk.split_launches(
                    idxs, prepared, flen, talco_cuda.p8_of(p), 4, 128):
                st = pack(chunk, prepared, metas, task, p, False, param,
                          flen, xdrop, 1024, pin=True, padlen=padlen)
                paths, tail = ti.launch(torch, st, p)
                nlaunch += 1
                for bi, i in enumerate(chunk):
                    jobs.append({"p": p, "leaf": False, "marker": 1024,
                                 "task": task, "prep": prepared[i],
                                 "meta": metas[i], "flen": flen[i],
                                 "xdrop": xdrop[i], "native": True,
                                 "plain": False})
                    kern.append((paths[bi, :tail[bi, 0]].copy(),
                                 tail[bi].copy(),
                                 (p, task, flen[i], prepared[i][4])))
                if flen is wide and (p, task) == (6, 0):
                    timing = (st, chunk, padlen, paths, tail, prepared,
                              metas, param, flen, xdrop)
    check(talco_cuda.talco_align.launches - launches0 == nlaunch,
          "wide parity: launch counter mismatch")
    t0 = time.time()
    refs = ti.host_refs(mp_pool, jobs)
    bad, max_err, errs, _ = ti.hold(kern, refs, "wide parity")
    n_cross = sum(_crosses_w_s(kt, key[3]) for _, kt, key in kern)
    narrow = [int(kt[1]) for _, kt, key in kern if key[2] == 4096]
    widened = [int(kt[1]) for _, kt, key in kern if key[2] > 4096]
    widths = sorted({key[2] for _, _, key in kern if key[2] > 4096})
    print(f"[wide parity] {len(widened)} pairs at ladder width 4096 "
          f"(errors {sorted(set(narrow))}) and at {widths} (errors "
          f"{sorted(set(widened))}) in {nlaunch} launches; native host "
          f"kernel on {workers} CPU workers in {time.time() - t0:.1f} s; "
          f"mismatches {bad}; max |kernel - host| {max_err} (tolerance 0); "
          f"{n_cross} pairs whose band crosses W_S", flush=True)
    check(bad == 0, f"wide parity: {bad} of {len(jobs)} runs differ")
    check(len(widened) >= 16 and set(narrow) == {2} and set(widened) == {0},
          "wide parity: not every pair gave error 2 at 4096 and a path at "
          "the wide width")

    st, chunk, padlen, paths, tail, prepared, metas, param, flen, xdrop = \
        timing
    b = len(chunk)
    prod, res, _, ttail = ti.launch_times(torch, st, 6, b, padlen, 2)
    check(np.array_equal(ttail, tail), "wide time: results changed")
    cells = int(tail[:, 2].astype(np.int64).sum())
    # the plain version on the pair with the fewest diagonals
    k = min(range(b), key=lambda k: int(tail[k, 3]))
    one = pack([chunk[k]], prepared, metas, 0, 6, False, param, flen, xdrop,
               1024, padlen=padlen)
    plain_ms = _plain_ms(torch, one, 6, paths[k:k + 1], tail[k:k + 1],
                         "wide time")
    out = {"pairs": b, "padlen": padlen, "xdrop": WIDE_XDROP,
           "widths": [flen[i] for i in chunk],
           "ms_per_pair_h2d_kernel_d2h": prod / b,
           "ms_per_pair_resident": res / b, "ms_per_launch_resident": res,
           "max_diagonals_per_pair": int(tail[:, 3].max()),
           "us_per_diagonal": 1e3 * res / int(tail[:, 3].max()),
           "mean_band": cells / int(tail[:, 3].astype(np.int64).sum()),
           "dp_cells": cells, "gcells_per_s_resident": cells / (res * 1e6),
           "h2d_bytes": int(st.buf.numel()),
           "plain_ms_per_pair": plain_ms,
           "plain_shape": f"nt freq {prepared[chunk[k]][4][0]} x "
                          f"{prepared[chunk[k]][4][1]}, width "
                          f"{flen[chunk[k]]}, {int(tail[k, 3])} diagonals, "
                          f"{int(tail[k, 2])} cells"}
    ti.talco_bound(out, "nt freq", b, padlen)
    print("[wide time] nt freq: " + json.dumps(out), flush=True)
    return max_err, out, n_cross


def phase_long_time(torch):
    """Kernel time on the long route at the launch size the batcher picks:
    nt freq and nt leaf at 29-30 kb, protein freq at 2.9-3 kb; and the
    plain version's time on CUDA tensors for one ~3000-column nt freq
    pair (a 30 kb pair through it takes minutes)."""
    import numpy as np
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.ops.device_kernel import Params
    from twilight_tpu_torch.tools.talco_inputs import make_pair, pack
    from twilight_tpu_torch.tools import talco_inputs as ti
    rng = np.random.default_rng(8)
    shapes = [("nt freq", 6, False, 29000, 30000),
              ("nt leaf", 6, True, 29000, 30000),
              ("protein freq", 22, False, 2900, 3000)]
    out = {}
    for name, p, leaf, lo, hi in shapes:
        param = Params.make("n" if p == 6 else "p")
        rows, esz = (1, 1) if leaf else (talco_cuda.p8_of(p), 4)
        # pairs for one launch: the batcher's cut of 128 such pairs
        # (the budgets bind first on the long freq route)
        b = len(dk.split_launches(
            list(range(128)), [(None,) * 4 + ((hi, hi),)] * 128,
            [4096] * 128, rows, esz, 128)[0][0])
        prepared, metas = zip(*[make_pair(rng, p, leaf,
                                          int(rng.integers(lo, hi)), cap=hi)
                                for _ in range(b)])
        flen, xdrop = [4096] * b, [5000] * b
        idxs = sorted(range(b), key=lambda i: -sum(prepared[i][4]))
        (chunk, padlen), = dk.split_launches(idxs, prepared, flen, rows,
                                             esz, 128)
        st = pack(chunk, prepared, metas, 0, p, leaf, param, flen, xdrop,
                  1024, pin=True, padlen=padlen)
        prod, res, paths, tail = ti.launch_times(torch, st, p, b, padlen, 3)
        check((tail[:, 1] == 0).all(),
              f"long time/{name}: kernel errors {np.unique(tail[:, 1])}")
        cells = int(tail[:, 2].astype(np.int64).sum())
        diags = int(tail[:, 3].astype(np.int64).sum())
        res_ = {"pairs": b, "padlen": padlen,
                "ms_per_pair_h2d_kernel_d2h": prod / b,
                "ms_per_pair_resident": res / b,
                "ms_per_launch_resident": res,
                "ms_per_launch_h2d_kernel_d2h": prod,
                "dp_cells": cells, "diagonals": diags,
                "max_diagonals_per_pair": int(tail[:, 3].max()),
                "us_per_diagonal": 1e3 * res / int(tail[:, 3].max()),
                "gcells_per_s_resident": cells / (res * 1e6),
                "h2d_bytes": int(st.buf.numel())}
        ti.talco_bound(res_, name, b, padlen)
        out[name] = res_
        print(f"[long time] {name}: " + json.dumps(res_), flush=True)
    # the plain version for one ~3000-column nt freq pair (long route)
    param = Params.make("n")
    prep, meta = ti.long_pair(rng, 6, False, 3000, 3001)
    padlen = dk.launch_padlen(max(prep[4]))
    st = pack([0], [prep], [meta], 0, 6, False, param, [4096], [5000], 1024,
              padlen=padlen)
    paths, tail = ti.launch(torch, st, 6)
    check(tail[0, 1] == 0, "long time/plain: kernel error")
    plain_ms = _plain_ms(torch, st, 6, paths, tail, "long time/plain")
    out["plain"] = {"ms_per_pair": plain_ms,
                    "shape": f"nt freq {prep[4][0]} x {prep[4][1]}, padlen "
                             f"{padlen}, {int(tail[0, 3])} diagonals, "
                             f"{int(tail[0, 2])} cells"}
    print("[long time] plain version on CUDA tensors: "
          + json.dumps(out["plain"]), flush=True)
    return out


def phase_gate(torch):
    """One launch round trip through the batcher, the figure behind the
    level gate (pipeline/aligner.py LAUNCH_ROUND_TRIP_S; measured by
    tools/talco_inputs.gate_round_trip)."""
    from twilight_tpu_torch.tools.talco_inputs import gate_round_trip
    out = gate_round_trip(torch)
    print("[gate] launch round trip: " + json.dumps(out), flush=True)
    return out


def _probe_bits_equal(a, b):
    """(equal, max |a - b| over positions finite in both): equal means
    the same NaN positions and the same bits elsewhere."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    same = bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(torch.int32)[~na], b.view(torch.int32)[~nb]))
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return same, err


def probe_instances():
    """(variant, layout) of every probe kernel instance: the 9 one-block
    instances, then the 9 cluster instances."""
    from twilight_tpu_torch.ops import probe_loop
    return ([(n, "block") for n in probe_loop.REFERENCES]
            + [(n, "cluster") for n in probe_loop.CLUSTER_VARIANTS])


def _probe_checks(torch, probe_loop, name, layout, out, key):
    """One instance through its kernel at 2, 6 and 40 trips, bit-equal to
    its plain version, offset off and on (body/scratch then finite); its
    attributes (a cluster instance: 8 CTAs, at least one cluster
    resident, no local bytes); a cluster instance bit-equal to the
    one-block one at PROBE_AB_TRIPS."""
    ref = probe_loop.REFERENCES[name]
    worst = 0.0
    for offset in (False, True):
        for trips in (2, 6, 40):
            got = probe_loop.run(name, trips, out, layout, offset).clone()
            torch.cuda.synchronize()
            want = ref(trips, "cuda", offset)
            same, err = _probe_bits_equal(got, want)
            worst = max(worst, err)
            check(same, f"probes/{key}: kernel != plain version at "
                        f"{trips} trips (offset {offset})")
            if name == "body/scratch" and offset and trips < 40:
                check(bool(torch.isfinite(got).all()),
                      f"probes/{key}: not finite with the offset at "
                      f"{trips} trips")
    attr = probe_loop.attributes(name, layout)
    rec = {"name": name, "layout": layout, "max_abs_err": worst,
           "attributes": attr}
    if layout == "cluster":
        check(attr["cluster_size"] == probe_loop.GRP
              and attr["max_active_clusters"] >= 1
              and attr["local_bytes"] == 0,
              f"probes/{key}: cluster attributes {attr}")
        got = probe_loop.run(name, PROBE_AB_TRIPS, out, "cluster").clone()
        block = probe_loop.run(name, PROBE_AB_TRIPS, out, "block").clone()
        torch.cuda.synchronize()
        same, err = _probe_bits_equal(got, block)
        check(same, f"probes/{key}: cluster != one block at "
                    f"{PROBE_AB_TRIPS} trips")
        rec["max_abs_err_vs_block"] = err
    return rec


def _live_walk_checks(torch, probe_loop, out):
    """deadcode and nested+walk in both layouts with the walks live (2
    trips, the offset, walk_floor PROBE_LIVE_WALK_FLOOR): bit-equal to
    the plain version, whose walks emit in every tile. A CTA that started
    the walks from its own row maximum would emit another count (the row
    maxima differ by row with the offset), so the exchange before the
    walks is seen."""
    res = {}
    for name in probe_loop.WALK_VARIANTS:
        emits = []
        want = probe_loop.REFERENCES[name](2, "cuda", True,
                                           PROBE_LIVE_WALK_FLOOR, emits)
        check(min(emits) > 0, f"probes/{name}: the live walks emit {emits}")
        for layout in probe_loop.LAYOUTS:
            got = probe_loop.run(name, 2, out, layout, True,
                                 PROBE_LIVE_WALK_FLOOR).clone()
            torch.cuda.synchronize()
            same, err = _probe_bits_equal(got, want)
            check(same, f"probes/{name} [{layout}]: kernel != plain version "
                        "with live walks")
            res[f"{name} [{layout}]"] = {"emits": emits, "max_abs_err": err}
    return res


def phase_probes(torch):
    """The loop-cost probes (K6-K10): each of the 9 variants as one block
    and as one cluster of 8 CTAs, held to their plain versions and to
    each other (_probe_checks), and the walks live (_live_walk_checks);
    then the port's probe tool (the main path of these kernels) times
    every instance, with the launch counts zeroed just
    before and read just after; the plain version's time per step; last,
    scalar0d/body's and /both's cluster instances of the barrier-exchange
    build, held to the same checks and timed."""
    from twilight_tpu_torch.ops import build, probe_loop
    from twilight_tpu_torch.tools import probe_loop_costs as tool
    out = torch.empty((probe_loop.GRP, probe_loop.W), dtype=torch.float32,
                      device="cuda")
    res = {}
    for name, layout in probe_instances():
        key = f"{name} [{layout}]"
        res[key] = _probe_checks(torch, probe_loop, name, layout, out, key)
    print("[probes] live walks (2 trips, offset, walk_floor "
          f"{PROBE_LIVE_WALK_FLOOR}): "
          + json.dumps(_live_walk_checks(torch, probe_loop, out)), flush=True)
    probe_loop.reset_launches()
    for r in res.values():
        r["ns_per_step"] = tool.ns_per_step(r["name"], layout=r["layout"])
    launches = {fn.__name__: {"block": fn.launches - fn.cluster_launches,
                              "cluster": fn.cluster_launches}
                for fn in probe_loop.WRAPPERS}
    plain = {}
    for name, ref in probe_loop.REFERENCES.items():
        lo, hi = PROBE_PLAIN_TRIPS
        t = []
        for trips in (lo, hi):
            best = float("inf")
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref(trips, "cuda")
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            t.append(best)
        steps = (hi - lo) * (2 if name.startswith("nested") else 1)
        plain[name] = 1e9 * (t[1] - t[0]) / steps
    for key, r in res.items():
        r["plain_ns_per_step"] = plain[r["name"]]
        print(f"[probes] {key}: " + json.dumps(r), flush=True)
    print(f"[probes] launches on the tool's run: {json.dumps(launches)}",
          flush=True)
    for name, layout in probe_instances():
        fn = name.split("/")[0].split("+")[0]
        check(launches[fn][layout] > 0,
              f"probes: {fn} never launched its {layout} instance on the "
              "tool's run")
    with build.variant(*tool.exchange_flags("barrier")):
        for name in ("scalar0d/body", "scalar0d/both"):
            key = f"{name} [cluster, barrier exchange]"
            rec = _probe_checks(torch, probe_loop, name, "cluster", out, key)
            rec["ns_per_step"] = tool.ns_per_step(name, layout="cluster")
            rec["async_ns_per_step"] = res[f"{name} [cluster]"]["ns_per_step"]
            print(f"[probes] {key}: " + json.dumps(rec), flush=True)
    cond = res["scalar0d/cond [cluster]"]["ns_per_step"]
    bare = res["body/carried [cluster]"]["ns_per_step"]
    print("[probes] the split step's parts, cluster: body/carried (the "
          f"bare step) {bare:.1f} ns; scalar0d/cond - body/carried (bias "
          f"and condition) {cond - bare:.1f} ns; deadcode - body/carried "
          f"{res['deadcode [cluster]']['ns_per_step'] - bare:.1f} ns; "
          "body/scratch - body/carried (the rows in shared memory) "
          f"{res['body/scratch [cluster]']['ns_per_step'] - bare:.1f} ns",
          flush=True)
    floor = res["carcass [cluster]"]["ns_per_step"]
    print("[probes] the cluster layout's loop floor (carcass, cluster) "
          f"{floor:.1f} ns, one block "
          f"{res['carcass [block]']['ns_per_step']:.1f} ns; body/carried - "
          f"carcass, cluster (the body's chain and its CTA barrier) "
          f"{bare - floor:.1f} ns", flush=True)
    print("[probes] the row maxima's exchange a step, scalar0d/both - "
          f"scalar0d/cond: st.async and mbarrier "
          f"{res['scalar0d/both [cluster]']['ns_per_step'] - cond:.1f} ns, "
          f"cluster barrier {rec['ns_per_step'] - cond:.1f} ns", flush=True)
    return res, launches


def _md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        while block := f.read(1 << 24):
            h.update(block)
    return h.hexdigest()


def device_env(force, steal):
    """TWILIGHT_FORCE_DEVICE when `force`, TWILIGHT_NO_STEAL unless
    `steal`; neither otherwise."""
    os.environ.pop("TWILIGHT_FORCE_DEVICE", None)
    os.environ.pop("TWILIGHT_NO_STEAL", None)
    if force:
        os.environ["TWILIGHT_FORCE_DEVICE"] = "1"
    if not steal:
        os.environ["TWILIGHT_NO_STEAL"] = "1"


def e2e_run(torch, runs, td, label, argv, golden, device=True, force=True,
            steal=False, task0_errors=0):
    """One run of the port's entry point, held to md5 `golden` (None: no
    pinned value). `force` sends every level's DP to the device
    (TWILIGHT_FORCE_DEVICE; else the level-size gate picks host or device
    per level), and unless `steal` no host thread steals a pair
    (TWILIGHT_NO_STEAL). A forced run must resolve every non-empty pair
    on the device, bar those stolen and exactly `task0_errors` pairs that
    the reference defers at task 0 (the device's error is their answer;
    None: as many as the batcher counted, printed with the run).
    The launch counts (in all and by kernel instance) are zeroed just
    before the run and read just after."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.ops import talco_cuda
    out = os.path.join(td, label + ".aln")
    device_env(force, steal)
    talco_cuda.talco_align.launches = 0
    talco_cuda.talco_align.by_instance.clear()
    t0 = time.time()
    rc, kernel = cli.run(argv + ["-o", out])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = talco_cuda.talco_align.launches
    check(rc == 0, f"e2e/{label}: exit code {rc}")
    md5 = _md5(out)
    rec = {"wall_s": wall, "md5": md5, "launches": launches,
           "by_instance": dict(talco_cuda.talco_align.by_instance)}
    if device:
        rec.update(kernel.stats)
    runs[label] = rec
    print(f"[e2e] {label}: " + json.dumps(rec), flush=True)
    check(golden is None or md5 == golden,
          f"e2e/{label}: md5 {md5} != {golden}")
    if device:
        st = kernel.stats
        check(launches == st["launches"],
              f"e2e/{label}: {launches} kernel launches, the batcher "
              f"counted {st['launches']}")
    if device and force:
        check(launches > 0, f"e2e/{label}: the kernel never launched")
        if task0_errors is None:
            task0_errors = st["task0_errors"]
        check(st["task0_errors"] == task0_errors,
              f"e2e/{label}: {st['task0_errors']} task-0 errors, expected "
              f"{task0_errors}")
        check(steal or st["host_stolen"] == 0,
              f"e2e/{label}: {st['host_stolen']} pairs stolen with "
              "TWILIGHT_NO_STEAL set")
        check(st["pairs_on_device"] + task0_errors + st["host_stolen"]
              == st["pairs"] - st["zero_length"],
              f"e2e/{label}: {st['pairs_on_device']} of "
              f"{st['pairs'] - st['zero_length']} non-empty pairs resolved "
              f"on the device ({st['host_stolen']} stolen, {task0_errors} "
              "deferred at task 0)")
    return rec


def simulate(td, name, *args):
    """The simulated set `name` (made once a run), as -t/-i arguments."""
    prefix = os.path.join(td, name)
    if os.path.exists(prefix + ".fa") and os.path.exists(prefix + ".nwk"):
        return ["-t", prefix + ".nwk", "-i", prefix + ".fa"]
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m",
                        "twilight_tpu_torch.tools.simulate",
                        *args, "-o", prefix], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, f"simulate failed: {r.stderr[-500:]}")
    print(f"[e2e] {name} generated in {time.time() - t0:.1f} s", flush=True)
    return ["-t", prefix + ".nwk", "-i", prefix + ".fa"]


def phase_e2e(torch, td):
    runs = {}

    def run(*a, **k):
        return e2e_run(torch, runs, td, *a, **k)

    prot = os.path.join(REPO, "tests", "data", "prot_16")
    run("prot_16", ["--backend", "cuda", "-t", prot + ".nwk", "-i",
                    prot + ".fa", "--type", "p"], GOLDEN_PROT16)
    sim = simulate(td, *SIM2K) + ["--rooted"]
    run("sim2k_cuda", ["--backend", "cuda"] + sim, GOLDEN_SIM2K)
    run("sim2k_native", ["--backend", "native"] + sim, GOLDEN_SIM2K,
        device=False)
    # host threads steal pairs from the tail while the launches are in
    # flight (both engines give the same bits)
    run("sim2k_cuda_steal", ["--backend", "cuda"] + sim, GOLDEN_SIM2K,
        steal=True)
    # the default --backend cuda run: the level-size gate picks host or
    # device per level, and host threads steal
    run("sim2k_cuda_hybrid", ["--backend", "cuda"] + sim, GOLDEN_SIM2K,
        force=False, steal=True)
    # the true default: no --backend flag (auto takes the card), no
    # environment knobs
    run("sim2k_default", sim, GOLDEN_SIM2K, force=False, steal=True)
    # 706 deferred sequences realigned one pair per level at task 1,
    # where errors 1/2 take the retry ladder
    run("sim2k_defer_cuda", ["--backend", "cuda", "--length-deviation",
                             "0.02"] + sim, GOLDEN_SIM2K_DEFER)
    # divergent 2 kb sequences: X-drop bands far wider than the TPU
    # kernel's starting window
    div = simulate(td, "div8", "-n", "8", "-l", "2000", "-m", "0.25",
                   "--seed", "13")
    want = run("div8_native", ["--backend", "native"] + div, None,
               device=False)["md5"]
    run("div8_cuda", ["--backend", "cuda"] + div, want)
    return runs


def _with_unrelated(argv, td, name, index, length, seed):
    """The simulated set of argv with sequence `index` replaced by an
    unrelated random sequence of `length` letters (same tree)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    src = argv[argv.index("-i") + 1]
    recs, cur = [], None
    with open(src) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                cur = [line, []]
                recs.append(cur)
            elif line:
                cur[1].append(line)
    recs[index][1] = ["".join(np.array(list("ACGT"))[
        rng.integers(0, 4, length)])]
    dst = os.path.join(td, name + ".fa")
    with open(dst, "w") as f:
        for head, body in recs:
            f.write(head + "\n" + "".join(body) + "\n")
    return ["-t", argv[argv.index("-t") + 1], "-i", dst]


def phase_long_e2e(torch, td):
    """Long genomes and proteins through the entry point with the device
    forced, each md5-equal to --backend native in this process: 20 x 30 kb
    nt (the sars_20 shape; pinned md5), 12 x 3 kb protein (pinned md5),
    and the 30 kb set with one sequence replaced by an unrelated 5 kb one
    and --length-deviation 0.1, so that its deferred realignment at task
    1 climbs the retry ladder past width 4096 (wide launches)."""
    runs = {}

    def run(*a, **k):
        return e2e_run(torch, runs, td, *a, **k)

    s20 = simulate(td, "s20", "-n", "20", "-l", "30000", "--seed", "5")
    p12 = simulate(td, "p12", "--type", "p", "-n", "12", "-l", "3000",
                   "--seed", "5") + ["--type", "p"]
    w20 = _with_unrelated(s20, td, "w20", 7, 5000, 11) \
        + ["--length-deviation", "0.1"]
    # w20's unrelated sequence is deferred at task 0: one device error
    for label, argv, golden, task0 in (("s20", s20, GOLDEN_S20, 0),
                                       ("p12", p12, GOLDEN_P12, 0),
                                       ("w20", w20, None, 1)):
        cuda = run(label + "_cuda", ["--backend", "cuda"] + argv, golden,
                   task0_errors=task0)
        native = run(label + "_native", ["--backend", "native"] + argv,
                     golden, device=False)
        check(cuda["md5"] == native["md5"],
              f"e2e/{label}: cuda md5 {cuda['md5']} != native "
              f"{native['md5']}")
        check(cuda["host_wide"] == 0, f"e2e/{label}: host_wide > 0")
        if label == "w20":
            check(cuda["wide_launches"] > 0 and cuda["ladder_relaunches"] > 0,
                  "e2e/w20: no wide launch on the ladder")
        else:
            check(cuda["long_launches"] > 0, f"e2e/{label}: no long launch")
    return runs

# ---------------------------------------------------------------------------
# the workflows (python -m twilight_tpu_torch.workflow) and their products
# ---------------------------------------------------------------------------

def _read_fasta(path):
    from twilight_tpu_torch.seqio.fasta import iter_fasta
    return {n: s for n, _, s in iter_fasta(path)}


def _read(path):
    with open(path) as f:
        return f.read().strip()


def _clean_env():
    """The workflows run as a user runs them: no forcing, stealing on."""
    os.environ.pop("TWILIGHT_FORCE_DEVICE", None)
    os.environ.pop("TWILIGHT_NO_STEAL", None)


def _batcher_ms(torch):
    """What a fresh DP batcher costs an alignment (each iteration's
    cli.run makes one and closes it): set-up and close, the median of 5."""
    from twilight_tpu_torch.config import Options, Params
    from twilight_tpu_torch.ops.device_kernel import DeviceTalco
    param, walls = Params.make("n"), []
    for _ in range(6):
        t0 = time.perf_counter()
        DeviceTalco(Options(device_backend="cuda", type="n"), param,
                    "cuda").close()
        walls.append(time.perf_counter() - t0)
    return float(sorted(walls[1:])[2]) * 1e3


def run_workflow(torch, td, sim, goldens, type_=None):
    """Iterative mode on the simulated set `sim`, two iterations, with the
    default backend (auto: the card) and temp files kept: each step's
    wall, the launches of each alignment, one count product on the card
    (pair_counts_on.calls, zeroed just before), the peak device memory;
    iter0.nwk, iter1.nwk and the final MSA must equal, by md5, `goldens`
    (those of the whole workflow run with --backend native; the Gram
    product is on the host in both, the counts are exact). Returns (the
    record, the temp dir, the output, the input FASTA)."""
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.trees import estimate
    from twilight_tpu_torch.workflow import iterative
    name = sim[0]
    fa = simulate(td, *sim)[3]
    wd = os.path.join(td, f"wf_{name}_default")
    out = os.path.join(td, f"wf_{name}_default.aln")
    _clean_env()
    estimate.pair_counts_on.calls = 0
    talco_cuda.talco_align.launches = 0
    talco_cuda.talco_align.by_instance.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    steps = iterative.run_iterative(fa, out, iterations=2, temp_dir=wd,
                                    type_=type_, backend="auto",
                                    keep_temp=True)
    wall = time.time() - t0
    launches = talco_cuda.talco_align.launches
    print(f"[workflow] {name}, 2 iterations, default backend: {wall:.3f} "
          "s; steps " + json.dumps(steps), flush=True)
    aligns = [s for s in steps if s["step"].startswith("align")]
    check(estimate.pair_counts_on.calls == 1,
          f"workflow/{name}: {estimate.pair_counts_on.calls} count products "
          "on the card, want 1")
    check(all(s["launches"] > 0 for s in aligns)
          and sum(s["launches"] for s in aligns) == launches,
          f"workflow/{name}: launches by iteration "
          f"{[s['launches'] for s in aligns]}, {launches} counted")
    got = {n: hashlib.md5(_read(os.path.join(wd, n)).encode()).hexdigest()
           for n in ("iter0.nwk", "iter1.nwk")}
    got["final"] = _md5(out)
    for n, want in zip(("iter0.nwk", "iter1.nwk", "final"), goldens):
        check(got[n] == want, f"workflow/{name}: {n} md5 {got[n]} != "
              f"{want}, the whole native workflow's")
    rec = {"wall_s": wall, "steps": steps, "launches": launches,
           "by_instance": dict(talco_cuda.talco_align.by_instance),
           "md5": got["final"], "tree0_md5": got["iter0.nwk"],
           "tree1_md5": got["iter1.nwk"],
           "peak_device_gib": torch.cuda.max_memory_allocated() / (1 << 30)}
    return rec, wd, out, fa


def phase_workflow(torch, td):
    """Iterative mode on sim10k (run_workflow, GOLDEN_WF10K_*), its SP
    score, and what a fresh DP batcher costs an iteration."""
    from twilight_tpu_torch.config import Params
    from twilight_tpu_torch.tools.sp_score import sp_score
    rec, wd, out, fa = run_workflow(
        torch, td, SIM10K,
        (GOLDEN_WF10K_TREE0, GOLDEN_WF10K_TREE1, GOLDEN_WF10K))
    param = Params.make("n")
    sp = sp_score(list(_read_fasta(out).values()), "n", param)
    batcher_ms = _batcher_ms(torch)
    rec.update(sp_score=sp, batcher_ms=batcher_ms)
    print("[workflow] " + json.dumps(
        {k: v for k, v in rec.items() if k != "steps"}), flush=True)
    print(f"[workflow] iter0.nwk, iter1.nwk and the final md5 equal the "
          f"whole native workflow's; SP {sp:.1f}; a fresh batcher "
          f"{batcher_ms:.2f} ms per iteration", flush=True)
    return {"rec": rec, "fa": fa, "out": out,
            "iter0": _read_fasta(os.path.join(wd, "iter0.aln"))}


def _product(torch, name, host, card, resident, h2d, ops, in_bytes):
    """Times one count product: the host NumPy route, the card route with
    its copies (the median of PRODUCT_REPS after a warm-up), its torch
    calls on resident tensors (one torch.matmul an output, so also the
    library's time) and the copies alone (CUDA events); holds the card's
    counts to the host's bit for bit."""
    import numpy as np
    from twilight_tpu_torch.tools.talco_inputs import timed
    from twilight_tpu_torch.tools import talco_inputs as ti
    t0 = time.perf_counter()
    want = host()
    host_ms = (time.perf_counter() - t0) * 1e3
    card()
    walls = []
    for _ in range(PRODUCT_REPS):
        t0 = time.perf_counter()
        got = card()
        walls.append(time.perf_counter() - t0)
    out_bytes = sum(g.nbytes for g in got)
    dev_out = [torch.empty(g.shape, dtype=torch.float32, device="cuda")
               for g in got]
    host_out = [np.empty_like(g) for g in got]

    def d2h():
        for h, d in zip(host_out, dev_out):
            torch.from_numpy(h).copy_(d)

    rec = {"name": name, "outputs": len(got),
           "with_copies_ms": float(np.median(walls)) * 1e3,
           "card_ms": timed(torch, resident, 5),
           "h2d_ms": timed(torch, h2d, 3), "d2h_ms": timed(torch, d2h, 3),
           "host_ms": host_ms, "ops": ops, "bytes": in_bytes + out_bytes}
    rec["bound_ms"], rec["bound_by"] = ti.bound_ms(ops, in_bytes + out_bytes)
    rec["library_ms"] = rec["card_ms"]
    rec["bit_equal"] = all(np.array_equal(g, w) for g, w in zip(got, want))
    check(rec["bit_equal"], f"products/{name}: counts differ from the "
          "host's")
    print(f"[products] {json.dumps(rec)}", flush=True)
    return rec


def phase_products(torch, wf):
    """The workflow's two count products at full size on the card against
    the host NumPy route: the msa match/valid counts of the workflow's
    iter0.aln and placement's counts of 5000 query rows against 5000
    backbone rows of its final MSA, bit-equal; TF32 off inside the
    products; and the round trip of pair_counts_on on a [64, 1024] block
    (the gate's figure, trees/estimate.PRODUCT_ROUND_TRIP_S). The Gram
    product runs on the host only (trees/estimate._gram)."""
    import numpy as np
    from twilight_tpu_torch.trees import estimate
    from twilight_tpu_torch.workflow import placement
    cuda = torch.device("cuda")
    with estimate.ieee_f32():
        tf32 = {"fp32_precision": torch.backends.cuda.matmul.fp32_precision,
                "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    tf32["outside the products"] = torch.backends.cuda.matmul.fp32_precision
    print(f"[products] TF32 inside the products: {json.dumps(tf32)}",
          flush=True)
    check(tf32["fp32_precision"] == "ieee" and not tf32["allow_tf32"],
          "products: TF32 on inside the products")

    def counts(name, a, b, letters, host, card):
        da, va = estimate.one_hots_on(a, letters, cuda)
        db, vb = (da, va) if b is None else estimate.one_hots_on(b, letters,
                                                                 cuda)

        def resident():
            with estimate.ieee_f32():
                return da @ db.T, va @ vb.T

        def h2d():
            for mat in (a,) if b is None else (a, b):
                torch.from_numpy(np.ascontiguousarray(mat)).to(cuda)

        rows_b = a.shape[0] if b is None else b.shape[0]
        ops = 2.0 * a.shape[0] * rows_b * a.shape[1] * (len(letters) + 1)
        in_bytes = a.nbytes + (0 if b is None else b.nbytes)
        return _product(torch, name, host, card, resident, h2d, ops,
                        in_bytes)

    seqs = _read_fasta(wf["fa"])
    rows0 = wf["iter0"]
    mat, is_gap = estimate.msa_columns([rows0[k] for k in seqs])
    letters = estimate.msa_letters(mat)
    recs = [counts(
        f"msa counts [{mat.shape[0]}, {mat.shape[1]}] x {len(letters)} "
        "letters", mat, None, letters,
        lambda: estimate.host_msa_counts(mat, is_gap, letters),
        lambda: estimate.pair_counts_on(mat, None, letters, cuda))]
    final = _read_fasta(wf["out"])
    rows = np.stack([np.frombuffer(final[k].upper().encode(), np.uint8)
                     for k in seqs])
    q, bb = rows[:PLACE_ROWS], rows[PLACE_ROWS:2 * PLACE_ROWS]
    cols = q.shape[1]
    step = cols // 4096 + 1 if cols > 4096 else 1
    recs.append(counts(
        f"placement counts [{PLACE_ROWS}] x [{PLACE_ROWS}], "
        f"{q[:, ::step].shape[1]} columns x 4 letters",
        q[:, ::step], bb[:, ::step], b"ACGT",
        lambda: placement.placement_counts(q, bb),
        lambda: placement.placement_counts(q, bb, device=cuda)))

    small = np.ascontiguousarray(rows[:64, :1024])
    estimate.pair_counts_on(small, None, b"ACGT", cuda)
    walls = []
    for _ in range(50):
        t0 = time.perf_counter()
        estimate.pair_counts_on(small, None, b"ACGT", cuda)
        walls.append(time.perf_counter() - t0)
    rt = {"shape": list(small.shape), "letters": 4,
          "round_trip_ms": float(np.median(walls)) * 1e3,
          "min_ms": min(walls) * 1e3, "max_ms": max(walls) * 1e3,
          "constant_ms": estimate.PRODUCT_ROUND_TRIP_S * 1e3}
    print(f"[products] round trip of pair_counts_on: {json.dumps(rt)}",
          flush=True)
    return recs, rt


def phase_placement(torch, td):
    """Placement mode: a simulated set of 2500 x 1 kb, its first 2000 rows
    aligned on the card with their pruned true tree, the other 500 placed
    with -t that tree and -n 2 through the workflow's command line with
    the default backend (the card: alignments and counts), md5-equal to
    the same run with --backend native."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.phylo.tree import Tree
    from twilight_tpu_torch.trees import estimate
    from twilight_tpu_torch.workflow import iterative
    sim = simulate(td, "pl2500", "-n", str(PLACE_N), "-l", "1000",
                   "--seed", "0")
    seqs = _read_fasta(sim[3])
    names = list(seqs)
    files = {k: os.path.join(td, "pl_" + k)
             for k in ("bb.fa", "q.fa", "bb.nwk", "bb.aln")}
    for key, part in (("bb.fa", names[:PLACE_BACKBONE]),
                      ("q.fa", names[PLACE_BACKBONE:])):
        with open(files[key], "w") as f:
            f.writelines(f">{n}\n{seqs[n]}\n" for n in part)
    pruned = Tree.from_newick_file(sim[1]).prune(set(names[:PLACE_BACKBONE]))
    with open(files["bb.nwk"], "w") as f:
        f.write(pruned.get_newick_string() + "\n")
    _clean_env()
    check(cli.main(["-t", files["bb.nwk"], "-i", files["bb.fa"], "-o",
                    files["bb.aln"]]) == 0, "placement: backbone failed")
    runs = {}
    for label, extra in (("cuda", []), ("native", ["--backend", "native"])):
        out = os.path.join(td, f"pl_{label}.aln")
        estimate.pair_counts_on.calls = 0
        talco_cuda.talco_align.launches = 0
        t0 = time.time()
        rc = iterative.main(["-i", files["q.fa"], "-a", files["bb.aln"],
                             "-t", files["bb.nwk"], "-n", "2", "-o", out,
                             "-d", os.path.join(td, f"pl_{label}")] + extra)
        runs[label] = {"wall_s": time.time() - t0, "rc": rc,
                       "launches": talco_cuda.talco_align.launches,
                       "card_counts": estimate.pair_counts_on.calls,
                       "md5": _md5(out) if rc == 0 else None}
        print(f"[placement] {label}: {json.dumps(runs[label])}", flush=True)
        check(rc == 0, f"placement/{label}: exit code {rc}")
    check(runs["cuda"]["launches"] > 0 and runs["cuda"]["card_counts"] == 1,
          "placement: the default run made no launch or no card product")
    check(runs["cuda"]["md5"] == runs["native"]["md5"],
          f"placement: md5 {runs['cuda']['md5']} != native "
          f"{runs['native']['md5']}")
    return runs


# one host of the multihost phase: forms the gloo group (rendezvous through
# a file; argv: rank, init method, then the command line), runs the port's
# command line, and prints its wall, launches and batcher counts
HOST_RUNNER = """
import datetime, json, sys, time
import torch.distributed as dist
rank, init = int(sys.argv[1]), sys.argv[2]
t0 = time.time()
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=600))
t1 = time.time()
from twilight_tpu_torch import cli
from twilight_tpu_torch.ops import talco_cuda
try:
    rc, kernel = cli.run(sys.argv[3:])
finally:
    dist.destroy_process_group()
print("HOST " + json.dumps({
    "rank": rank, "rc": rc, "group_s": t1 - t0, "wall_s": time.time() - t1,
    "launches": talco_cuda.talco_align.launches,
    "launches_by_device": kernel.stats["launches_by_device"] if kernel
    else []}), flush=True)
sys.exit(rc)
"""


def phase_multihost(torch, td):
    """Divide-and-conquer over two hosts: sim10k with its true tree,
    --rooted -m 2000, --backend cuda, as two processes on this card that
    form a torch.distributed gloo group (no host flags: the topology comes
    from the group) and exchange the subtree-root states by all-gather;
    host 0 merges and writes the MSA. Held: both processes launch the
    kernel, take the all-gather (no checkpoint polling), host 1 writes no
    output, and host 0's md5 equals a one-process --backend native run
    with the same -m (GOLDEN_MULTIHOST)."""
    argv = simulate(td, *SIM10K) + ["--rooted", "-m", str(MULTIHOST_M)]
    _clean_env()
    outs = [os.path.join(td, f"mh_h{r}.aln") for r in range(2)]
    logs = [os.path.join(td, f"mh_h{r}.log") for r in range(2)]
    init = "file://" + os.path.join(td, "mh_rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.time()
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", HOST_RUNNER, str(r), init] + argv
                + ["--backend", "cuda", "-d", os.path.join(td, "mh_shared"),
                   "-o", outs[r]], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PROC_TIMEOUT_S - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    both_s = time.time() - t0
    text = [_read(path) for path in logs]
    hosts = []
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"multihost: host {r} exited "
              f"{p.returncode}:\n{text[r][-3000:]}")
        rec = json.loads(re.search(r"^HOST (.*)$", text[r], re.M).group(1))
        rec["subtrees"] = int(re.search(rf"Host {r}/2: (\d+) subtrees",
                                        text[r]).group(1))
        rec["collective"] = (f"Host {r}: exchanging {rec['subtrees']} "
                             "subtree states by all-gather." in text[r])
        rec["file_polling"] = "waiting for" in text[r]
        hosts.append(rec)
        print(f"[multihost] host {r}: " + json.dumps(rec), flush=True)
        check(rec["launches"] > 0, f"multihost: host {r} never launched")
        check(rec["collective"] and not rec["file_polling"],
              f"multihost: host {r} did not exchange by all-gather")
    parts = int(re.search(r"Decomposed the tree into (\d+) subtrees",
                          text[0]).group(1))
    check(sum(h["subtrees"] for h in hosts) == parts,
          f"multihost: {[h['subtrees'] for h in hosts]} subtrees of "
          f"{parts}")
    check(not os.path.exists(outs[1]), "multihost: host 1 wrote an output")
    md5 = _md5(outs[0])
    check(md5 == GOLDEN_MULTIHOST, f"multihost: host 0's md5 {md5} != "
          f"native {GOLDEN_MULTIHOST}")
    res = {"subtrees": parts, "hosts": hosts, "both_s": both_s, "md5": md5}
    print(f"[multihost] sim10k -m {MULTIHOST_M}: {parts} subtrees, "
          f"{[h['subtrees'] for h in hosts]} a host; two processes on one "
          f"card {both_s:.3f} s (launches {[h['launches'] for h in hosts]})"
          f"; md5 {md5} equals one native process's", flush=True)
    return res


def phase_multidevice(torch, td):
    """Two launch queues on this card: DeviceTalco(devices=[cuda:0,
    cuda:0]) (each with its own stream and matrix copy) behind the
    command line, sim2k with the device forced and no stealing, in turns
    with the one-queue batcher (one, two, two, one). Held: the golden md5,
    and the launches split over both queues."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.ops.device_kernel import DeviceTalco
    sim = simulate(td, *SIM2K) + ["--rooted"]
    real = cli.make_device_kernel
    runs, walls = {}, {"one": [], "two": []}
    for turn, tag in enumerate(("one", "two", "two", "one")):
        if tag == "two":
            cli.make_device_kernel = lambda opt, param: DeviceTalco(
                opt, param, ["cuda:0", "cuda:0"])
        try:
            rec = e2e_run(torch, runs, td, f"sim2k_{tag}_queue_{turn}",
                          ["--backend", "cuda"] + sim, GOLDEN_SIM2K)
        finally:
            cli.make_device_kernel = real
        by = rec["launches_by_device"]
        check(len(by) == (2 if tag == "two" else 1) and all(by)
              and sum(by) == rec["launches"],
              f"multidevice: launches by queue {by}, {rec['launches']} "
              "launches")
        walls[tag].append(rec["wall_s"])
    print(f"[multidevice] sim2k forced, walls one queue {walls['one']} s, "
          f"two queues on cuda:0 {walls['two']} s; launches by queue "
          f"{[r['launches_by_device'] for r in runs.values()]}", flush=True)
    return {"walls": walls, "runs": runs}


# ---------------------------------------------------------------------------
# the CLI's last routes: checkpoint/resume, merge mode, cross-level rounds
# ---------------------------------------------------------------------------

class _Tee:
    """sys.stderr's stand-in that keeps what is written and passes it on
    (the port's threads print through sys.stderr too)."""

    def __init__(self, real):
        self.real, self.parts = real, []

    def write(self, text):
        self.parts.append(text)
        return self.real.write(text)

    def flush(self):
        self.real.flush()

    def text(self):
        return "".join(self.parts)


def tee_stderr():
    """A context in which what is written to sys.stderr is also kept (its
    value's text())."""
    import contextlib
    return contextlib.redirect_stderr(_Tee(sys.stderr))


def _subalignments(d):
    """The unexpanded subalignments (subtree-<i>.subalignment.aln) in d."""
    return sorted(f for f in os.listdir(d)
                  if f.endswith(".subalignment.aln"))


def phase_resume(torch, td):
    """Checkpoint/resume of divide-and-conquer on the card: sim10k with its
    true tree, --rooted -m 2000, --backend cuda, the device forced, through
    the entry point in this process, in four runs. (1) -k -d <dir>: md5
    GOLDEN_MULTIHOST (one native process's), one state checkpoint a
    subtree. (2) The same with --resume --overwrite: the same md5, every
    subtree resumed, and only the meta-tree merge's pairs launched (fewer
    launches than run 1, none of them leaf). (3) A fresh dir with
    --resume and no -k, the port's update_and_write_alignment patched to
    raise on its second call: the injected error must come up through the
    entry point, every unexpanded subalignment must still be there and no
    output written. (4) The same command with --overwrite: every subtree
    resumed, the same md5, the temp dir removed."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.seqio import writer
    argv = ["--backend", "cuda"] + simulate(td, *SIM10K) \
        + ["--rooted", "-m", str(MULTIHOST_M)]
    runs = {}

    def run(label, extra):
        with tee_stderr() as err:
            rec = e2e_run(torch, runs, td, label, argv + extra,
                          GOLDEN_MULTIHOST, task0_errors=None)
        rec["resumed"] = err.text().count("Resumed subtree")
        return rec, err.text()

    keep = os.path.join(td, "resume_keep")
    first, text = run("sim10k_m2000", ["-k", "-d", keep])
    parts = int(re.search(r"Decomposed the tree into (\d+) subtrees",
                          text).group(1))
    states = [f for f in os.listdir(keep) if f.endswith(".state.npz")]
    check(len(states) == parts and first["resumed"] == 0,
          f"resume: {len(states)} checkpoints of {parts} subtrees, "
          f"{first['resumed']} resumed in the first run")
    again, _ = run("sim10k_m2000_resumed",
                   ["-k", "-d", keep, "--resume", "--overwrite"])
    check(again["resumed"] == parts,
          f"resume: {again['resumed']} of {parts} subtrees resumed")
    check(0 < again["launches"] < first["launches"]
          and again["leaf_launches"] == 0 and again["pairs"] == parts - 1,
          f"resume: the resumed run made {again['launches']} launches "
          f"({again['leaf_launches']} leaf) for {again['pairs']} pairs, "
          f"the first {first['launches']}; want only the meta-tree's "
          f"{parts - 1} pairs")

    crash_dir = os.path.join(td, "resume_crash")
    label = "sim10k_m2000_after_crash"
    crash_args = argv + ["-d", crash_dir, "--resume", "-o",
                         os.path.join(td, label + ".aln")]
    real, calls, seen = writer.update_and_write_alignment, [0], None

    def crashing(*args):
        total = real(*args)
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected merge-phase crash")
        return total

    device_env(True, False)
    writer.update_and_write_alignment = crashing
    t0 = time.time()
    try:
        cli.run(crash_args)
    except RuntimeError as e:
        seen = str(e)
    finally:
        writer.update_and_write_alignment = real
    crash_s = time.time() - t0
    check(seen == "injected merge-phase crash",
          f"resume: the injected error did not come up ({seen!r})")
    subs = _subalignments(crash_dir)
    check(len(subs) == parts and not os.path.exists(crash_args[-1]),
          f"resume: {len(subs)} unexpanded subalignments of {parts} after "
          "the crash, or an output written")
    after, _ = run(label, ["-d", crash_dir, "--resume", "--overwrite"])
    check(after["resumed"] == parts and not os.path.exists(crash_dir),
          f"resume: {after['resumed']} of {parts} subtrees resumed after "
          "the crash, or the temp dir left")
    res = {"subtrees": parts, "keep": keep, "crash_s": crash_s,
           "runs": {k: {f: v[f] for f in ("wall_s", "launches", "pairs",
                                          "leaf_launches", "task0_errors",
                                          "resumed")}
                    for k, v in runs.items()}}
    print("[resume] " + json.dumps(res), flush=True)
    return res


def phase_merge(torch, td, resumed):
    """Merge mode (-f) on the card: the resume phase's first run's
    unexpanded subalignments (one MSA of ~2000 rows a subtree) copied into
    a directory and merged with the device forced, then with --backend
    native, in this process: the md5s equal, the card run launching."""
    import shutil
    msas = os.path.join(td, "merge_msas")
    os.makedirs(msas)
    subs = _subalignments(resumed["keep"])
    check(len(subs) == resumed["subtrees"],
          f"merge: {len(subs)} subalignments of {resumed['subtrees']}")
    rows = []
    for f in subs:
        shutil.copy(os.path.join(resumed["keep"], f), msas)
        rows.append(len(_read_fasta(os.path.join(msas, f))))
    runs = {}
    cuda = e2e_run(torch, runs, td, "merge_cuda",
                   ["--backend", "cuda", "-f", msas, "-d",
                    os.path.join(td, "merge_tmp_cuda")], None)
    native = e2e_run(torch, runs, td, "merge_native",
                     ["--backend", "native", "-f", msas, "-d",
                      os.path.join(td, "merge_tmp_native")], None,
                     device=False)
    check(cuda["md5"] == native["md5"], f"merge: cuda md5 {cuda['md5']} "
          f"!= native {native['md5']}")
    print(f"[merge] {len(subs)} MSAs of {rows} rows: cuda "
          f"{cuda['wall_s']:.3f} s ({cuda['launches']} launches, "
          f"{cuda['pairs']} pairs), native {native['wall_s']:.3f} s; md5 "
          f"{cuda['md5']}", flush=True)
    return {"rows": rows, "cuda": cuda, "native": native}


def phase_crosslevel(torch, td, per_level):
    """Cross-level rounds (TWILIGHT_CROSS_LEVEL=1) on sim2k --rooted: the
    device forced (-v, with TWILIGHT_PROFILE: the batcher's call lines,
    printed here under [crosslevel], and the rounds), no --backend flag
    with stealing on, --length-deviation 0.02 forced (the order-sensitive
    deferral path, GOLDEN_SIM2K_DEFER), and forced over two queues of
    cuda:0 as phase_multidevice builds them (both must launch). Each run's
    launches and wall are printed beside the e2e phase's per-level run of
    the same flags, when that phase ran."""
    from twilight_tpu_torch import cli
    from twilight_tpu_torch.ops.device_kernel import DeviceTalco
    sim = simulate(td, *SIM2K) + ["--rooted"]
    runs = {}
    os.environ["TWILIGHT_CROSS_LEVEL"] = "1"
    real = cli.make_device_kernel
    try:
        os.environ["TWILIGHT_PROFILE"] = "1"
        with tee_stderr() as err:
            forced = e2e_run(torch, runs, td, "sim2k_xl_cuda",
                             ["--backend", "cuda", "-v"] + sim,
                             GOLDEN_SIM2K)
        os.environ.pop("TWILIGHT_PROFILE")
        text = err.text()
        calls = re.findall(r"^ *\[dev\] call done: .*$", text, re.M)
        rounds = len(re.findall(r"^Round \d+, aligned", text, re.M))
        check(calls and rounds, f"crosslevel: {len(calls)} call lines, "
              f"{rounds} rounds")
        for line in calls:
            print(f"[crosslevel] {line.strip()}", flush=True)
        forced["rounds"] = rounds
        dflt = e2e_run(torch, runs, td, "sim2k_xl_default", sim,
                       GOLDEN_SIM2K, force=False, steal=True)
        check(dflt["launches"] > 0,
              "crosslevel: the default backend made no launch")
        e2e_run(torch, runs, td, "sim2k_xl_defer_cuda",
                ["--backend", "cuda", "--length-deviation", "0.02"] + sim,
                GOLDEN_SIM2K_DEFER)
        cli.make_device_kernel = lambda opt, param: DeviceTalco(
            opt, param, ["cuda:0", "cuda:0"])
        two = e2e_run(torch, runs, td, "sim2k_xl_two_queues",
                      ["--backend", "cuda"] + sim, GOLDEN_SIM2K)
    finally:
        cli.make_device_kernel = real
        os.environ.pop("TWILIGHT_CROSS_LEVEL", None)
        os.environ.pop("TWILIGHT_PROFILE", None)
    by = two["launches_by_device"]
    check(len(by) == 2 and all(by), f"crosslevel: launches by queue {by}")
    pairs = (("sim2k_xl_cuda", "sim2k_cuda"),
             ("sim2k_xl_default", "sim2k_default"),
             ("sim2k_xl_defer_cuda", "sim2k_defer_cuda"),
             ("sim2k_xl_two_queues", None))
    for xl, base in pairs:
        r = runs[xl]
        b = (per_level or {}).get(base)
        was = (f"; per level {b['wall_s']:.3f} s, {b['launches']} launches"
               if b else "")
        print(f"[crosslevel] {xl}: {r['wall_s']:.3f} s, {r['launches']} "
              f"launches{was}", flush=True)
    print(f"[crosslevel] sim2k forced: {rounds} rounds, two queues "
          f"{by}", flush=True)
    return runs


# ---------------------------------------------------------------------------
# the last modules: SASS census, graft entry, sharding, dry run
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# scale: divide-and-conquer at the size the JAX package was validated at
# ---------------------------------------------------------------------------

def _rss_gib():
    """(current RSS, max RSS so far) of this process, GiB."""
    import resource
    with open("/proc/self/status") as f:
        now = int(re.search(r"^VmRSS:\s+(\d+) kB", f.read(), re.M).group(1))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return now / (1 << 20), peak / (1 << 20)


def phase_scale(torch, td, sim=SIM40K, golden=GOLDEN_SIM40K,
                which=("forced", "default"), m=SCALE_M, extra=()):
    """Default mode with divide-and-conquer at scale (`sim`: sim40k, or
    sim100k for scale100k, or prot20k with `extra` --type p for the
    protein phase), --rooted -m `m` and `extra`, through the entry point in
    this process, each run of `which` held to md5 `golden`. Run A
    ("forced"), the card takes every pair (--backend cuda, the device
    forced, no stealing): held to launches above 0, to launches above 0 of
    both kernel instances of the run's profile width (leaf and freq), and
    to every non-empty pair resolved on the card or deferred at task 0
    (e2e_run); device_kernel.pack_batch is wrapped to count the freq pairs
    packed with a side above 10000 sequences (each must carry gap_char 0),
    at least one, with the largest ref_num * qry_num, the widest padlen
    and the widest side. The DP sees each profile without its gappy
    columns (above 95% gaps, -r 0.95), so at sim40k every side stays
    within 2048 columns. Run C ("all_columns", the scale_r1 phase): the
    same with -r 1 (no column removed), so that the pairs near the
    subtrees' tops and the meta-tree merge, sides above 10000 sequences
    among them, go by long launches (up to ~10k columns at sim40k): held
    to long launches above 0 and to pairs above 10000 sequences packed
    past padlen 2048. Run B ("default"), the user's run (no --backend
    flag, no environment knobs): its launches and stolen pairs. Each run
    prints its wall,
    launches by route, pairs on the card, stolen, task-0 errors,
    host_wide, the peak device memory, this process's RSS after the run
    and its max RSS so far, the subtrees' sizes and widths and the
    output's bytes; each output is deleted once its md5 is taken."""
    from twilight_tpu_torch.ops import device_kernel as dk
    from twilight_tpu_torch.ops import talco_cuda
    name = sim[0]
    args = simulate(td, *sim) + ["--rooted", "-m", str(m), *extra]
    p = 22 if "p" in extra else 6
    runs = {}
    real = dk.pack_batch

    def run(label, extra, want, packed=None, **kw):
        def counting(chunk, prepared, metas, task, padlen, *a, **k):
            st = real(chunk, prepared, metas, task, padlen, *a, **k)
            gap_char = st.floats.numpy()[2]
            for bi, i in enumerate(chunk):
                rnum, qnum = metas[i][2], metas[i][3]
                packed["pairs"] += 1
                packed["max_product"] = max(packed["max_product"],
                                            rnum * qnum)
                packed["max_side"] = max(packed["max_side"],
                                         *prepared[i][4])
                if max(rnum, qnum) > 10000:
                    packed["above_10000"] += 1
                    packed["above_10000_max_padlen"] = max(
                        packed["above_10000_max_padlen"], padlen)
                    check(gap_char[bi] == 0.0,
                          f"{name}: a pair of {rnum} and {qnum} sequences "
                          f"packed with gap_char {gap_char[bi]}")
            packed["max_padlen"] = max(packed["max_padlen"], padlen)
            return st

        torch.cuda.reset_peak_memory_stats()
        if packed is not None:
            dk.pack_batch = counting
        try:
            with tee_stderr() as err:
                rec = e2e_run(torch, runs, td, label, extra + args + [
                    "-d", os.path.join(td, label + "_tmp")], want, **kw)
        finally:
            dk.pack_batch = real
        out = os.path.join(td, label + ".aln")
        rec["output_bytes"] = os.path.getsize(out)
        os.remove(out)
        rec["peak_device_gib"] = torch.cuda.max_memory_allocated() / (1 << 30)
        rec["rss_gib"], rec["max_rss_gib"] = _rss_gib()
        # pinned host blocks the caching host allocator holds (staging and
        # result buffers, active + cached)
        rec["pinned_gib"] = torch.cuda.host_memory_stats()[
            "allocated_bytes.current"] / (1 << 30)
        text = err.text()
        rec["subtrees"] = [int(n) for n in re.findall(
            r"^Number : (\d+)$", text, re.M)]
        rec["widths"] = [int(n) for n in re.findall(
            r"^Subalignment Length: (\d+)$", text, re.M)]
        whole = re.search(r"^Alignment on \d+ subalignments \(length: "
                          r"(\d+)\)", text, re.M)
        rec["width"] = int(whole.group(1)) if whole else None
        print(f"[{name}] {label}: wall {rec['wall_s']:.3f} s; launches "
              f"{rec['launches']} (leaf {rec['leaf_launches']}, long "
              f"{rec['long_launches']}, wide {rec['wide_launches']}; by "
              f"instance {json.dumps(rec['by_instance'])}); pairs "
              f"{rec['pairs']}, on the card {rec['pairs_on_device']}, stolen "
              f"{rec['host_stolen']}, task-0 errors {rec['task0_errors']}, "
              f"host_wide {rec['host_wide']}; peak device memory "
              f"{rec['peak_device_gib']:.3f} GiB; RSS {rec['rss_gib']:.3f} "
              f"GiB, max {rec['max_rss_gib']:.3f} GiB, pinned host "
              f"{rec['pinned_gib']:.3f} GiB; subtrees "
              f"{rec['subtrees']} of widths {rec['widths']}, whole "
              f"{rec['width']}; output {rec['output_bytes']} bytes; md5 "
              f"{rec['md5']}", flush=True)
        check(len(rec["subtrees"]) > 1 and sum(rec["subtrees"])
              == int(sim[sim.index("-n") + 1]),
              f"{name}/{label}: subtrees {rec['subtrees']}")
        if packed is not None:
            rec["packed"] = packed
            print(f"[{name}] {label}: {packed['pairs']} freq pairs packed, "
                  f"{packed['above_10000']} with a side above 10000 "
                  f"sequences (gap_char 0; widest padlen among them "
                  f"{packed['above_10000_max_padlen']}), largest ref_num * "
                  f"qry_num {packed['max_product']}, widest padlen "
                  f"{packed['max_padlen']}, widest side "
                  f"{packed['max_side']} columns", flush=True)
            check(packed["above_10000"] > 0, f"{name}/{label}: no pair with "
                  "a side above 10000 sequences was packed")
            for leaf in (True, False):
                inst = talco_cuda.instance_name(p, leaf)
                check(rec["by_instance"].get(inst, 0) > 0,
                      f"{name}/{label}: {inst} never launched")
        return rec

    def counts():
        return dict.fromkeys(("pairs", "above_10000", "max_product",
                              "max_padlen", "max_side",
                              "above_10000_max_padlen"), 0)

    res = {}
    if "forced" in which:
        res["forced"] = run(f"{name}_m{m}_cuda", ["--backend", "cuda"],
                            golden, counts(), task0_errors=None)
    if "all_columns" in which:
        res["all_columns"] = c = run(
            f"{name}_m{m}_r1_cuda", ["--backend", "cuda", "-r", "1"],
            golden, counts(), task0_errors=None)
        check(c["long_launches"] > 0
              and c["packed"]["above_10000_max_padlen"] > dk.SHORT_PADLEN,
              f"{name}: -r 1 made {c['long_launches']} long launches, and "
              "packed its pairs above 10000 sequences at padlen "
              f"{c['packed']['above_10000_max_padlen']}")
    if "default" in which:
        res["default"] = run(f"{name}_m{m}_default", [], golden,
                             force=False, steal=True)
        check(res["default"]["launches"] > 0,
              f"{name}: the default run made no launch")
    return res


def changed_blosum62():
    """A user matrix unlike any -b one: the port's BLOSUM62 scores (x 5)
    with 15 added on the diagonal and W-Y set to 20."""
    import numpy as np
    from twilight_tpu_torch.config import Params
    from twilight_tpu_torch.constants import letter_idx
    mat = Params.make("p").scoring_matrix.copy()
    mat[np.arange(20), np.arange(20)] += 15
    w, y = letter_idx("p", "W"), letter_idx("p", "Y")
    mat[w, y] = mat[y, w] = 20
    return mat


def phase_protein(torch, td, smi_line):
    """The protein path at a protein user's sizes, through the entry points
    in this process, each run held to recorded md5s (no native process):
    prot20k (20000 x ~400 residues) --type p --rooted -m PROT_M forced and
    with no --backend flag (phase_scale: 3 subtrees, a meta-tree merge with
    a side above 10000 sequences, both protein kernel instances
    launching); the prot5k workflow (run_workflow, --type p:
    its protein count product on the card, with the letters, the one-hot
    bytes and the peak device memory printed); prot_16 forced with -b 45
    and -b 80 (the reference goldens) and with -x files written by
    config.write_matrix_file: BLOSUM62 as -b 62 scores it (GOLDEN_PROT16)
    and changed_blosum62 in another letter order (GOLDEN_PROT16_XCHANGED).
    Ends with one [protein] summary line."""
    from twilight_tpu_torch.config import Params, write_matrix_file
    from twilight_tpu_torch.trees import estimate
    res = {"prot20k": phase_scale(torch, td, PROT20K, GOLDEN_PROT20K,
                                  m=PROT_M, extra=("--type", "p"))}
    rec, wd, _, _ = run_workflow(
        torch, td, PROT5K,
        (GOLDEN_WFP5K_TREE0, GOLDEN_WFP5K_TREE1, GOLDEN_WFP5K), type_="p")
    # what the count product of iteration 1 took: iter0's columns, masked
    # and subsampled as msa_distances does, and their letters
    mat, _ = estimate.msa_columns(
        list(_read_fasta(os.path.join(wd, "iter0.aln")).values()))
    letters = estimate.msa_letters(mat)
    rec.update(count_rows=mat.shape[0], count_columns=mat.shape[1],
               letters=len(letters),
               one_hot_bytes=4 * mat.shape[0] * mat.shape[1] * len(letters))
    print("[protein] workflow prot5k: " + json.dumps(
        {k: v for k, v in rec.items() if k != "steps"}), flush=True)
    res["workflow"] = rec

    runs = {}
    prot = os.path.join(REPO, "tests", "data", "prot_16")
    base = ["--backend", "cuda", "-t", prot + ".nwk", "-i", prot + ".fa",
            "--type", "p"]
    x62, xch = (os.path.join(td, n) for n in ("blosum62.x", "changed.x"))
    write_matrix_file(x62, "p", Params.make("p").scoring_matrix, AA20)
    write_matrix_file(xch, "p", changed_blosum62(), XCHANGED_ORDER)
    for label, extra, golden in (
            ("prot_16_b45", ["-b", "45"], GOLDEN_PROT16_B45),
            ("prot_16_b80", ["-b", "80"], GOLDEN_PROT16_B80),
            ("prot_16_x62", ["-x", x62], GOLDEN_PROT16),
            ("prot_16_xchanged", ["-x", xch], GOLDEN_PROT16_XCHANGED)):
        e2e_run(torch, runs, td, label, base + extra, golden)
    res["matrices"] = runs

    f, d = res["prot20k"]["forced"], res["prot20k"]["default"]
    wall = {s["step"]: round(s["s"], 3) for s in rec["steps"]}
    print(f"[protein] summary: prot20k --type p --rooted -m {PROT_M} "
          f"forced {f['wall_s']:.3f} s ({f['launches']} launches by "
          f"instance {json.dumps(f['by_instance'])}, long "
          f"{f['long_launches']}, wide {f['wide_launches']}; "
          f"{f['packed']['above_10000']} pairs packed with a side above "
          f"10000, gap_char 0; peak device {f['peak_device_gib']:.3f} GiB, "
          f"RSS {f['rss_gib']:.3f} GiB), no flag {d['wall_s']:.3f} s "
          f"({d['launches']} launches, {d['host_stolen']} stolen), md5 "
          f"{f['md5']}; workflow prot5k -n 2 {rec['wall_s']:.3f} s (steps "
          f"{json.dumps(wall)}; one count product on the card, L "
          f"{rec['letters']}, one-hots {rec['one_hot_bytes']} bytes; peak "
          f"device {rec['peak_device_gib']:.3f} GiB), trees and final md5 "
          f"the native workflow's; prot_16 forced: " + ", ".join(
              f"{k[8:]} {r['md5'][:8]} ({r['launches']} launches)"
              for k, r in runs.items()) + f"; card {smi_line}", flush=True)
    return res


def phase_protein_trace(torch, td):
    """Where prot20k's forced run (as the protein phase runs it) spends
    its time: the run under a torch.profiler trace (the CLI's
    --profile-trace), held to GOLDEN_PROT20K and to every launch showing
    in the trace; the TALCO kernels' device time, the copies', the card's
    busy time and its idle share over the run's wall."""
    from twilight_tpu_torch.tools.talco_inputs import trace_device_ms
    trace = os.path.join(td, "prot20k_trace")
    tr = e2e_run(torch, {}, td, "prot20k_traced", [
        "--backend", "cuda", *simulate(td, *PROT20K), "--type", "p",
        "--rooted", "-m", str(PROT_M), "-d",
        os.path.join(td, "prot20k_traced_tmp"), "--profile-trace", trace],
        GOLDEN_PROT20K, task0_errors=None)
    os.remove(os.path.join(td, "prot20k_traced.aln"))
    tr.update(trace_device_ms(os.path.join(trace, "trace.json")))
    tr["idle_share"] = 1.0 - tr["busy_ms"] / (1e3 * tr["wall_s"])
    print("[protein_trace] prot20k forced, traced: " + json.dumps(
        {k: tr[k] for k in ("wall_s", "launches", "talco_kernels", "talco_ms",
                            "kernel_ms", "copy_ms", "busy_ms",
                            "idle_share")}), flush=True)
    check(tr["talco_kernels"] == tr["launches"],
          f"protein_trace: the trace shows {tr['talco_kernels']} TALCO "
          f"kernels of {tr['launches']} launches")
    return tr


def phase_census(attributes):
    """The instruction mix of every kernel instance (tools/sass_census.py
    on the built libraries). Held: all 22 instances are there, none
    whose cudaFuncGetAttributes local size is 0 has LDL/STL, no probe
    instance has an FFMA (they divide nothing), and no cluster instance
    has local bytes. Each TALCO instance's FFMA count is printed with its
    source, not checked: under -fmad=false the correctly rounded
    division's own fma remains."""
    from twilight_tpu_torch.ops import probe_loop
    from twilight_tpu_torch.tools import sass_census
    res = sass_census.census(sass_census.listing())
    missing = [i for i in sass_census.EXPECTED if i not in res]
    check(not missing, f"census: no SASS for {missing}")
    for inst in sass_census.EXPECTED:
        r = res[inst]
        r["local_bytes"] = (attributes[inst]["local_bytes"]
                            if inst.startswith("talco") else
                            probe_loop.attributes(r["variant"], r["layout"])
                            ["local_bytes"])
        print(f"[census] {inst}: " + json.dumps(r), flush=True)
        check(r["local_bytes"] > 0 or r["ldl"] + r["stl"] == 0,
              f"census: {inst} has {r['ldl']} LDL and {r['stl']} STL, but "
              "cudaFuncGetAttributes reports no local bytes")
        check("variant" not in r or r["ffma"] == 0,
              f"census: {inst} ({r.get('variant')}) has {r['ffma']} FFMA")
        check(r.get("layout") != "cluster" or r["local_bytes"] == 0,
              f"census: {inst} spills ({r['local_bytes']} local bytes)")
    print("[census]\n" + sass_census.table(
        {i: res[i] for i in sass_census.EXPECTED}), flush=True)
    for inst in sass_census.EXPECTED[:4]:
        r = res[inst]
        print(f"[census] {inst}: FFMA {r['ffma']} ({r['ffma_source']}); "
              f"LDL/STL {r['ldl']}/{r['stl']} against "
              f"{r['local_bytes']} local bytes", flush=True)
    return res


def _hold_oracle(paths, tail, pairs, flen, label):
    """Each (prep, meta) pair's kernel path against the oracle at ladder
    width `flen`, task 0; returns the pairs held."""
    from twilight_tpu_torch.graft_entry import oracle_ladder
    for i, (prep, meta) in enumerate(pairs):
        gold = oracle_ladder(prep, meta, 0, flen)
        n = int(tail[i, 0])
        check(gold is not None and int(tail[i, 1]) == 0 and n == len(gold)
              and (paths[i, :n] == gold).all(),
              f"{label}: pair {i} differs from the oracle (tail "
              f"{tail[i].tolist()}, oracle "
              f"{None if gold is None else len(gold)} steps)")
    return len(pairs)


def phase_entry(torch, smi_line):
    """entry() on cuda:0: one launch of the TALCO step, held byte for byte
    to the plain version on the same CUDA tensors and to the oracle, its
    resident time (CUDA events, the launch alone) printed; then
    get_sharded_batch_kernel over [cuda:0, cuda:0] (a stream a shard) on 8
    pairs, one launch a shard, held to the oracle."""
    from twilight_tpu_torch import graft_entry
    from twilight_tpu_torch.ops import talco_cuda
    from twilight_tpu_torch.parallel import sharding
    from twilight_tpu_torch.tools import talco_inputs as ti
    step, args = graft_entry.entry()
    check(all(t.is_cuda for t in args) and step.matrix.is_cuda,
          "entry: entry() did not put the step on the card")
    n0 = talco_cuda.talco_align.launches
    paths, tail = step(*args)
    torch.cuda.synchronize()
    launched = talco_cuda.talco_align.launches - n0
    check(launched == 1, f"entry: the step made {launched} launches")
    ints, floats, offs, ref, qry = args
    plain = talco_cuda.talco_align_reference(
        ints, floats, ref, qry, step.matrix, p=step.p, marker=step.marker)
    same = torch.equal(paths, plain[0]) and torch.equal(tail, plain[1])
    err = int((paths.int() - plain[0].int()).abs().max())
    paths, tail = paths.cpu().numpy(), tail.cpu().numpy()
    pairs = graft_entry._example_pairs(graft_entry.BATCH,
                                       graft_entry.PADLEN)
    held = _hold_oracle(paths, tail, pairs, graft_entry.FLEN, "entry")
    check(same, "entry: the step differs from its plain version on the "
          "same CUDA tensors")
    scratch = int(offs[-1])
    ms = ti.timed(torch, lambda: talco_cuda.talco_align(
        ints, floats, offs, ref, qry, step.matrix, p=step.p,
        marker=step.marker, scratch_bytes=scratch), 20)
    print(f"[entry] TalcoStep on cuda:0: one launch, {held} pairs x "
          f"{tail[0, 0]} steps, lengths {tail[:, 0].tolist()}, errors "
          f"{tail[:, 1].tolist()}; byte-equal to the plain version (max "
          f"|diff| {err}) and the oracle; resident {ms:.4f} ms a launch "
          f"(CUDA events, mean of 20); card {smi_line}", flush=True)
    # the sharded kernel over two queues on one card
    pairs8 = graft_entry._example_pairs(8, graft_entry.PADLEN, seed=1)
    batch = graft_entry._example_batch(8, seed=1)
    mesh = sharding.make_pair_mesh(["cuda:0", "cuda:0"])
    kern = sharding.get_sharded_batch_kernel(
        6, graft_entry.MARKER, graft_entry._nuc_matrix(), mesh)
    n0 = talco_cuda.talco_align.launches
    spaths, stail = kern(*(t.cuda() for t in batch))
    shard_launches = talco_cuda.talco_align.launches - n0
    check(shard_launches == len(mesh),
          f"entry: the sharded kernel made {shard_launches} launches over "
          f"{len(mesh)} shards")
    sheld = _hold_oracle(spaths.cpu().numpy(), stail.cpu().numpy(), pairs8,
                         graft_entry.FLEN, "entry/sharded")
    print(f"[entry] sharded over {[str(d) for d in mesh]}: {sheld} pairs in "
          f"{shard_launches} launches (a stream a shard), byte-equal to the "
          f"oracle; card {smi_line}", flush=True)
    return {"launches": launched, "resident_ms": ms, "max_abs_err": err,
            "sharded_pairs": sheld, "sharded_launches": shard_launches}


def phase_dryrun(torch, mp_pool):
    """graft_entry.dryrun_multichip(2): over two distinct cards when the
    machine has them, else two queues on cuda:0. The dry run itself holds
    every pair to the oracle (on the host pool) and every route and queue;
    here the card must have made the launches."""
    from twilight_tpu_torch import graft_entry
    two = torch.cuda.device_count() >= 2
    devices = None if two else ["cuda:0", "cuda:0"]
    where = ("two cards (cuda:0, cuda:1)" if two
             else "two queues on cuda:0 (the machine has one card)")
    res = graft_entry.dryrun_multichip(2, devices, pool=mp_pool)
    st = res["stats"]
    check(st["launches"] == sum(st["launches_by_device"]) > 0,
          f"dryrun: {st['launches']} card launches of "
          f"{st['launches_by_device']}")
    print(f"[dryrun] dryrun_multichip(2) over {where}: pairs "
          f"{json.dumps(res['pairs'])}, every one byte-equal to the oracle; "
          f"host_stolen {st['host_stolen']}, launches by queue "
          f"{st['launches_by_device']}, leaf {st['leaf_launches']}, long "
          f"{st['long_launches']}, wide {st['wide_launches']}, ladder "
          f"relaunches {st['ladder_relaunches']}", flush=True)
    print(f"[dryrun] {res['summary']}", flush=True)
    res["where"] = where
    return res


# ---------------------------------------------------------------------------
# the port's tools and its front door
# ---------------------------------------------------------------------------

def phase_fuzz(torch, mp_pool, workers):
    """The kernel fuzz (tools/fuzz_talco.py) on the card with a seed of its
    own (FUZZ_SEED): short (nt and protein, freq and leaf, 32 pairs each, 8
    of them at marker 64), long (8 pairs each) and wide (4 nt and 4 protein
    freq pairs, each at width 4096 and at 8192 or 16384), every run held to
    the oracle; none may differ, and errors 1 and 2 must both be seen."""
    from twilight_tpu_torch.tools import fuzz_talco
    print(f"[fuzz] seed {FUZZ_SEED}, oracle on {workers} CPU workers",
          flush=True)
    runs, errs = [], {}
    for route, n, marker in FUZZ_RUNS:
        t0 = time.time()
        res = fuzz_talco.fuzz(route, n, FUZZ_SEED, marker=marker,
                              pool=mp_pool)
        res["wall_s"] = time.time() - t0
        print("[fuzz] " + json.dumps(res), flush=True)
        runs.append(res)
        for e, c in res["errors"].items():
            errs[e] = errs.get(e, 0) + c
    pairs = sum(r["pairs"] for r in runs)
    bad = sum(r["mismatches"] for r in runs)
    by_route = {r: sum(x["pairs"] for x in runs if x["route"] == r)
                for r in fuzz_talco.ROUTES}
    print(f"[fuzz] {pairs} pairs ({json.dumps(by_route)}) in "
          f"{sum(r['runs'] for r in runs)} runs, "
          f"{sum(r['launches'] for r in runs)} launches; error codes "
          f"{json.dumps(errs)}; mismatches {bad} (tolerance 0: paths "
          "byte-equal, lengths and errors equal)", flush=True)
    check(bad == 0, f"fuzz: {bad} runs differ from the oracle")
    check(pairs >= 140, f"fuzz: {pairs} pairs, want 140")
    check(errs.get("1", 0) > 0 and errs.get("2", 0) > 0,
          "fuzz: errors 1 and 2 were not both exercised")
    return {"pairs": pairs, "by_route": by_route, "errors": errs,
            "runs": runs}


def phase_bench(torch, smi_line, timing):
    """The kernel bench (tools/bench_kernel.py --json) on every route: short
    nt freq (batch 128, 1700 columns), nt leaf, protein freq (400), long nt
    freq (30 kb, the batcher's launch) and wide nt freq (4750 columns,
    widths 8192/16384). Each line printed with the card's name and power
    limit, its us/diagonal beside PERF.md section 6's and, where the time
    phase ran, beside its (a print, not a check: the shapes differ)."""
    from twilight_tpu_torch.tools import bench_kernel
    out = {}
    for label, kw in BENCH_RUNS:
        res = bench_kernel.bench(batch=128, iters=5, **kw)
        out[label] = res
        print(f"[bench] {label}: {json.dumps(res)}; card {smi_line}",
              flush=True)
        check(res["err_rate"] == 0 and res["value"] > 0,
              f"bench/{label}: error rate {res['err_rate']}")
    now = {}
    if timing is not None:
        now = {f"short {k}": v["us_per_diagonal"] for k, v in timing.items()}
    print("[bench] us/diagonal, bench / PERF.md section 6 (review run, PR 4)"
          " / this run's time phase: " + "; ".join(
              f"{k} {v['us_per_diag']:.3f} / {PERF_US_PER_DIAG[k]:.3f} / "
              + (f"{now[k]:.3f}" if k in now else "-")
              for k, v in out.items()) + f"; card {smi_line}", flush=True)
    return out


def quality_start(td):
    """Starts the quality harness (tools/quality_harness.py --json) at
    sim2k's shape with --backend cuda and with --backend native, as two
    processes side by side (NJ of 2000 rows on the host is most of each
    run). Returns what phase_quality waits for."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("TWILIGHT_FORCE_DEVICE", "TWILIGHT_NO_STEAL"):
        env.pop(k, None)
    procs, files = {}, {}
    for backend in ("cuda", "native"):
        files[backend] = [os.path.join(td, f"quality_{backend}.{x}")
                          for x in ("out", "log")]
        with open(files[backend][0], "w") as out, \
                open(files[backend][1], "w") as log:
            procs[backend] = subprocess.Popen(
                [sys.executable, "-m",
                 "twilight_tpu_torch.tools.quality_harness", *QUALITY_ARGS,
                 "--backend", backend, "--json", "-d",
                 os.path.join(td, f"quality_{backend}")],
                cwd=REPO, env=env, stdout=out, stderr=log)
    return procs, files, time.time()


def phase_quality(started):
    """Waits for the two harness runs of quality_start and holds them: for
    every strategy the two outputs must be md5-equal, so their SP scores
    are; the card run must launch."""
    procs, files, t0 = started
    runs = {}
    try:
        for backend, proc in procs.items():
            proc.wait(timeout=max(1.0, PROC_TIMEOUT_S - (time.time() - t0)))
            out, log = files[backend]
            check(proc.returncode == 0, f"quality/{backend}: exit code "
                  f"{proc.returncode}:\n{_read(log)[-3000:]}")
            runs[backend] = json.loads(_read(out).splitlines()[-1])
            # its last line is the result: the file's time is the end's
            runs[backend]["process_s"] = os.path.getmtime(out) - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for backend, res in runs.items():
        print(f"[quality] --backend {backend}, {' '.join(QUALITY_ARGS)}: "
              + json.dumps(res), flush=True)
        for k, v in res["results"].items():
            print(f"[quality]   {backend} {k:14s} SP/pair "
                  f"{v['sp_per_pair']:.2f}, {v['pct_of_true_tree']:.2f}% of "
                  f"true-tree, {v['wall_s']:.3f} s, {v['launches']} "
                  f"launches, md5 {v['md5']}", flush=True)
    cuda, nat = runs["cuda"], runs["native"]
    check(cuda["backbone"]["md5"] == nat["backbone"]["md5"],
          "quality: the backbone's md5 differs between cuda and native")
    check(list(cuda["results"]) == list(nat["results"]),
          "quality: the two runs have different strategies")
    for k, v in nat["results"].items():
        c = cuda["results"][k]
        check(c["md5"] == v["md5"] and c["sp_per_pair"] == v["sp_per_pair"],
              f"quality/{k}: cuda md5 {c['md5']} != native {v['md5']}")
        check(v["launches"] == 0, f"quality/{k}: the native run launched")
    launched = cuda["backbone"]["launches"] + sum(
        v["launches"] for v in cuda["results"].values())
    check(launched > 0, "quality: the cuda run made no launch")
    print(f"[quality] every strategy md5-equal between cuda and native; the "
          f"cuda run made {launched} launches; processes "
          f"{cuda['process_s']:.3f} s and {nat['process_s']:.3f} s side by "
          "side (beside the parity phases' host references in a whole "
          "run)", flush=True)
    return runs


def phase_frontdoor(td):
    """The front door: prot_16 with --backend native through `python -m
    twilight_tpu_torch` as it runs, with torch refused, and with torch
    imported first (what every run paid before; it times the import), in
    turns (FRONTDOOR_REPS of each), each the golden md5; -h with torch
    refused. Walls are whole processes, by the host clock."""
    prot = os.path.join(REPO, "tests", "data", "prot_16")
    argv = ["-t", prot + ".nwk", "-i", prot + ".fa", "--type", "p",
            "--backend", "native", "--overwrite"]
    env = dict(os.environ, PYTHONPATH=REPO)
    variants = {"front door": ["-m", "twilight_tpu_torch"],
                "torch refused": ["-c", NO_TORCH],
                "torch imported first": ["-c", TORCH_FIRST]}

    def child(args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        return r, time.perf_counter() - t0

    walls = {k: [] for k in variants}
    imports = []
    out = os.path.join(td, "frontdoor.aln")
    for turn in range(FRONTDOOR_REPS):
        order = list(variants) if turn % 2 == 0 else list(variants)[::-1]
        for name in order:
            r, wall = child(variants[name] + argv + ["-o", out])
            check(r.returncode == 0, f"frontdoor/{name}: exit code "
                  f"{r.returncode}: {r.stderr[-1000:]}")
            check(_md5(out) == GOLDEN_PROT16,
                  f"frontdoor/{name}: md5 {_md5(out)}")
            if name == "torch refused":
                check("TORCH_ATTEMPTS []" in r.stderr,
                      "frontdoor: a host-only run tried to import torch")
            if name == "torch imported first":
                imports.append(float(re.search(
                    r"^IMPORT_TORCH_S (\S+)$", r.stderr, re.M).group(1)))
            walls[name].append(wall)
    r, _ = child(["-c", NO_TORCH, "-h"])
    check(r.returncode == 0 and "TORCH_ATTEMPTS []" in r.stderr,
          f"frontdoor: -h with torch refused: {r.stderr[-500:]}")
    res = {"import_torch_s": imports, "prot16_native_wall_s": walls,
           "md5": GOLDEN_PROT16, "help_without_torch": True}
    print("[frontdoor] " + json.dumps(res), flush=True)
    return res


PHASES = ("parity", "long_parity", "wide", "time", "long_time", "gate",
          "probes", "e2e", "long_e2e", "workflow", "products", "placement",
          "multihost", "multidevice", "fuzz", "bench", "quality",
          "frontdoor", "census", "entry", "dryrun", "resume", "merge",
          "crosslevel", "scale", "protein", "protein_trace", "scale_r1",
          "scale100k")
# phases that run only when --only names them (each a minute or more)
ON_REQUEST = {"protein_trace", "scale_r1", "scale100k"}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="the port's smoke test on one "
                                 "GPU (module doc)")
    ap.add_argument("--only", help="comma-separated phases to run (of "
                    f"{', '.join(PHASES)}; products needs workflow, merge "
                    "needs resume; protein_trace, scale_r1 and scale100k "
                    "run only when named here); "
                    "the kernels' JSON line needs all the others")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    if only is not None and (not only <= set(PHASES)
                             or ("products" in only
                                 and "workflow" not in only)
                             or ("merge" in only and "resume" not in only)):
        print(f"chip_smoke: --only {args.only}: phases are "
              f"{', '.join(PHASES)}; products needs workflow, merge needs "
              "resume", file=sys.stderr)
        return 2

    def want(phase):
        return phase not in ON_REQUEST if only is None else phase in only

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "twilight_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "twilight_tpu_torch package is not beside this script)",
              file=sys.stderr)
        return 2
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from twilight_tpu_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    # the card's name and power limit, as nvidia-smi gives them
    print(smi_line, flush=True)
    print(f"[device] torch: {kind}, {count} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.time()
    from twilight_tpu_torch.tools.probe_loop_costs import exchange_flags
    # with the probes' barrier-exchange build (the probes phase)
    build.prebuild((), exchange_flags("barrier"))
    build.load()
    build.load(build.PROBE)
    print(f"[build] nvcc {build.build_seconds or 0.0:.2f} s (one nvcc a "
          f"source and flag set, in parallel), load {time.time() - t0:.2f} "
          f"s, flags {' '.join(build.NVCC_FLAGS)}", flush=True)
    attributes = phase_build()

    # the native host kernel is the long phases' reference: build it once
    # here, before the workers start (each would build it otherwise)
    from twilight_tpu_torch.ops import talco_host
    check(talco_host.get_lib() is not None,
          "the native host kernel (twilight_tpu_torch/native/talco.cpp) "
          "did not build")

    def run(phase, fn, *args):
        """The phase's result (None when it is not run), its wall
        printed."""
        if not want(phase):
            return None
        t0 = time.time()
        res = fn(*args)
        print(f"[timing] {phase} {time.time() - t0:.3f} s", flush=True)
        return res

    census = run("census", phase_census, attributes)
    workers = max(1, min(8, os.cpu_count() or 1))
    with tempfile.TemporaryDirectory() as td:
        started = dryrun = None
        if any(want(p) for p in ("parity", "long_parity", "wide", "fuzz",
                                 "dryrun")):
            with ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                if want("wide"):
                    wide_err, wide, wide_cross = run(
                        "wide", phase_wide_parity, torch, pool, workers)
                # the quality harness's processes run beside the dry run
                # and the host references of the phases below, which time
                # nothing
                if want("quality"):
                    started = quality_start(td)
                dryrun = run("dryrun", phase_dryrun, torch, pool)
                parity_err = run("parity", phase_parity, torch, pool,
                                 workers)
                if want("long_parity"):
                    long_err, long_cross = run(
                        "long_parity", phase_long_parity, torch, pool,
                        workers)
                    # rows past W_S live in the pair's scratch, below it
                    # in shared memory
                    check(long_cross >= 10, f"parity: {long_cross} long "
                          "pairs whose band crosses W_S provably (want 10)")
                fuzz = run("fuzz", phase_fuzz, torch, pool, workers)
        if want("quality"):
            quality = run("quality", phase_quality,
                          started or quality_start(td))
        timing = run("time", phase_time, torch)
        long_time = run("long_time", phase_long_time, torch)
        gate = run("gate", phase_gate, torch)
        entry = run("entry", phase_entry, torch, smi_line)
        if want("probes"):
            probes, probe_launches = run("probes", phase_probes, torch)
        bench = run("bench", phase_bench, torch, smi_line, timing)
        runs = run("e2e", phase_e2e, torch, td)
        long_runs = run("long_e2e", phase_long_e2e, torch, td)
        wf = run("workflow", phase_workflow, torch, td)
        if want("products"):
            products, product_rt = run("products", phase_products, torch, wf)
        place = run("placement", phase_placement, torch, td)
        multihost = run("multihost", phase_multihost, torch, td)
        multidevice = run("multidevice", phase_multidevice, torch, td)
        resumed = run("resume", phase_resume, torch, td)
        merged = run("merge", phase_merge, torch, td, resumed)
        xl = run("crosslevel", phase_crosslevel, torch, td, runs)
        scale = run("scale", phase_scale, torch, td)
        protein = run("protein", phase_protein, torch, td, smi_line)
        run("protein_trace", phase_protein_trace, torch, td)
        run("scale_r1", phase_scale, torch, td, SIM40K, GOLDEN_SIM40K_R1,
            ("all_columns",))
        run("scale100k", phase_scale, torch, td, SIM100K, GOLDEN_SIM100K)
        frontdoor = run("frontdoor", phase_frontdoor, td)
    ok = json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}})
    if only is not None:
        # some phases only: no summary and no kernels line
        print(f"[summary] ran {', '.join(p for p in PHASES if want(p))}; "
              f"card {smi_line}", flush=True)
        print(ok, flush=True)
        return 0

    for label in ("sim2k", "s20", "p12", "w20"):
        r = runs if label == "sim2k" else long_runs
        print(f"[summary] {label} cuda {r[label + '_cuda']['wall_s']:.3f} s "
              f"vs native {r[label + '_native']['wall_s']:.3f} s on "
              f"{os.cpu_count()} cores; card {smi_line}", flush=True)
    # --backend cuda as a user runs it by default: the level gate (4 launch
    # round trips) sends the levels worth a launch to the card
    hyb = runs["sim2k_cuda_hybrid"]
    print(f"[summary] sim2k unforced (the default) {hyb['wall_s']:.3f} s, "
          f"{hyb['launches']} launches, {hyb['host_stolen']} stolen; forced "
          f"{runs['sim2k_cuda']['wall_s']:.3f} s; forced with stealing "
          f"{runs['sim2k_cuda_steal']['wall_s']:.3f} s "
          f"({runs['sim2k_cuda_steal']['host_stolen']} stolen); native "
          f"{runs['sim2k_native']['wall_s']:.3f} s; launch round trip "
          f"{gate['round_trip_ms']:.3f} ms; card {smi_line}", flush=True)
    check(hyb["launches"] >= 1,
          "e2e/sim2k_cuda_hybrid: the level gate sent no level to the card")
    dflt = runs["sim2k_default"]
    print(f"[summary] sim2k with no --backend flag: {dflt['wall_s']:.3f} s, "
          f"{dflt['launches']} launches, {dflt['host_stolen']} stolen; "
          f"card {smi_line}", flush=True)
    check(dflt["launches"] >= 1,
          "e2e/sim2k_default: the default backend made no launch")
    print("[summary] probes, ns/step: " + ", ".join(
        f"{n} {r['ns_per_step']:.1f}" for n, r in probes.items())
        + f"; card {smi_line}", flush=True)
    cl = {r["name"]: r for r in probes.values() if r["layout"] == "cluster"}
    print("[summary] probe clusters, ns/step against one block: " + ", ".join(
        f"{n} {r['ns_per_step']:.1f} vs "
        f"{probes[n + ' [block]']['ns_per_step']:.1f}" for n, r in cl.items())
        + "; the row maxima's exchange through distributed shared memory, "
        "scalar0d/both - scalar0d/cond: "
        f"{cl['scalar0d/both']['ns_per_step'] - cl['scalar0d/cond']['ns_per_step']:.1f}"
        f" ns a step; card {smi_line}", flush=True)
    us_diag = {f"short {k}": v["us_per_diagonal"] for k, v in timing.items()}
    us_diag.update({f"long {k}": v["us_per_diagonal"]
                    for k, v in long_time.items() if k != "plain"})
    us_diag["wide nt freq"] = wide["us_per_diagonal"]
    print("[summary] TALCO us/diagonal (launch time over its longest "
          "pair's diagonals): " + json.dumps(us_diag) + f"; card {smi_line}",
          flush=True)
    print("[summary] kernel attributes: " + json.dumps(attributes),
          flush=True)
    rec = wf["rec"]
    walls = {s["step"]: round(s["s"], 3) for s in rec["steps"]}
    print(f"[summary] workflow sim10k -n 2 (default backend): "
          f"{rec['wall_s']:.3f} s, steps {json.dumps(walls)}, launches by "
          f"iteration {[s['launches'] for s in rec['steps'] if 'launches' in s]}"
          f"; iter0.nwk, iter1.nwk and the final md5 the native workflow's; "
          f"SP {rec['sp_score']:.1f}; card {smi_line}", flush=True)
    print(f"[summary] placement 500 onto 2000, -n 2: default "
          f"{place['cuda']['wall_s']:.3f} s ({place['cuda']['launches']} "
          f"launches) vs native {place['native']['wall_s']:.3f} s; card "
          f"{smi_line}", flush=True)
    print("[summary] products, ms (card resident / with copies / host): "
          + "; ".join(f"{r['name']}: {r['card_ms']:.3f} / "
                      f"{r['with_copies_ms']:.3f} / {r['host_ms']:.1f}"
                      for r in products)
          + f"; round trip {product_rt['round_trip_ms']:.3f} ms; card "
          f"{smi_line}", flush=True)
    print(json.dumps({"products": products}), flush=True)
    print(f"[summary] multihost sim10k -m {MULTIHOST_M}: two processes "
          f"{multihost['both_s']:.3f} s (walls "
          f"{[round(h['wall_s'], 3) for h in multihost['hosts']]} s, "
          f"launches {[h['launches'] for h in multihost['hosts']]}, "
          f"subtrees {[h['subtrees'] for h in multihost['hosts']]}); card "
          f"{smi_line}", flush=True)
    print(f"[summary] multidevice sim2k forced: one queue "
          f"{multidevice['walls']['one']} s, two queues on cuda:0 "
          f"{multidevice['walls']['two']} s; card {smi_line}", flush=True)
    res = {k: (v["wall_s"], v["launches"], v["resumed"])
           for k, v in resumed["runs"].items()}
    print(f"[summary] resume sim10k -m {MULTIHOST_M}, forced, (wall s, "
          f"launches, subtrees resumed): {json.dumps(res)}; merge of "
          f"{len(merged['rows'])} subalignments: cuda "
          f"{merged['cuda']['wall_s']:.3f} s ({merged['cuda']['launches']} "
          f"launches) vs native {merged['native']['wall_s']:.3f} s; card "
          f"{smi_line}", flush=True)
    print("[summary] cross-level sim2k (wall s, launches) against per "
          "level: " + "; ".join(
              f"{k} {xl[k]['wall_s']:.3f}, {xl[k]['launches']} vs "
              f"{runs[b]['wall_s']:.3f}, {runs[b]['launches']}"
              for k, b in (("sim2k_xl_cuda", "sim2k_cuda"),
                           ("sim2k_xl_default", "sim2k_default"),
                           ("sim2k_xl_defer_cuda", "sim2k_defer_cuda")))
          + f"; forced {xl['sim2k_xl_cuda']['rounds']} rounds; card "
          f"{smi_line}", flush=True)
    print(f"[summary] scale {SIM40K[0]} --rooted -m {SCALE_M} (wall s; "
          "launches: leaf, long, wide; stolen; pairs packed with a side "
          "above 10000 at padlen up to; peak device GiB; RSS GiB): " + "; ".join(
              f"{k} {r['wall_s']:.3f}; {r['launches']}: {r['leaf_launches']}, "
              f"{r['long_launches']}, {r['wide_launches']}; "
              f"{r['host_stolen']}; "
              + (f"{r['packed']['above_10000']} at "
                 f"{r['packed']['above_10000_max_padlen']}; "
                 if "packed" in r else "")
              + f"{r['peak_device_gib']:.3f}; {r['rss_gib']:.3f}"
              for k, r in scale.items())
          + f"; card {smi_line}", flush=True)
    print(f"[summary] fuzz, seed {FUZZ_SEED}: {fuzz['pairs']} pairs "
          f"{json.dumps(fuzz['by_route'])}, error codes "
          f"{json.dumps(fuzz['errors'])}, none differs from the oracle; card "
          f"{smi_line}", flush=True)
    print("[summary] bench, pairs/s with copies (ms/pair resident, bound "
          "share): " + "; ".join(
              f"{k} {v['value']:.1f} ({v['ms_per_pair_resident']:.4f}, "
              f"{v['bound_share']:.4f})" for k, v in bench.items())
          + f"; card {smi_line}", flush=True)
    print(f"[summary] quality {' '.join(QUALITY_ARGS)}, SP/pair (% of "
          "true-tree), cuda md5-equal to native: " + ", ".join(
              f"{k} {v['sp_per_pair']:.2f} ({v['pct_of_true_tree']:.2f})"
              for k, v in quality["cuda"]["results"].items())
          + f"; card {smi_line}", flush=True)
    print(f"[summary] frontdoor: import torch "
          f"{json.dumps(frontdoor['import_torch_s'])} s; prot_16 --backend "
          "native process walls: " + json.dumps(
              frontdoor["prot16_native_wall_s"])
          + f"; card {smi_line}", flush=True)
    print("[summary] census (instructions, FFMA, LDL/STL, local bytes): "
          + "; ".join(f"{i} {census[i]['total']}, {census[i]['ffma']}, "
                      f"{census[i]['ldl']}/{census[i]['stl']}, "
                      f"{census[i]['local_bytes']}" for i in census
                      if i.startswith("talco")) + f"; card {smi_line}",
          flush=True)
    print(f"[summary] entry: one launch, resident {entry['resident_ms']:.4f}"
          f" ms; sharded {entry['sharded_pairs']} pairs in "
          f"{entry['sharded_launches']} launches; dryrun over "
          f"{dryrun['where']}: {dryrun['summary']}; card {smi_line}",
          flush=True)

    def talco(name, res, launches, err, plain_ms, replaces, key):
        # launches: the route's launches on its own path's forced run;
        # launches_sim40k: on the scale phase's forced run, counted from 0
        # just before it
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": res["ms_per_pair_resident"],
                "plain_ms": plain_ms, "bound_ms": res["bound_ms_per_pair"],
                "bound_by": res["bound_by"], "library_ms": None,
                "unit": "per pair", "us_per_diagonal": res["us_per_diagonal"],
                "launches_sim40k": scale["forced"][key]}

    nt = timing["nt freq"]
    kernels = [
        talco("talco_xdrop (K1/K2: freq and leaf, padlen 2048)", nt,
              runs["sim2k_cuda"]["launches"], parity_err,
              nt["plain_ms_per_pair"], REPLACES, "launches"),
        talco("talco_xdrop (K4: long route, padlen above 2048)",
              long_time["nt freq"], long_runs["s20_cuda"]["long_launches"],
              long_err, long_time["plain"]["ms_per_pair"], REPLACES_LONG,
              "long_launches"),
        talco("talco_xdrop (K5: wide route, ladder width above 4096)", wide,
              long_runs["w20_cuda"]["wide_launches"], wide_err,
              wide["plain_ms_per_pair"], REPLACES_WIDE, "wide_launches")]
    # the protein instances (the protein phase's path): launches on the
    # prot20k forced run and the prot5k workflow, each counted from 0 just
    # before it; times from the time phase (batch 128, padlen 2048)
    from twilight_tpu_torch.ops.talco_cuda import instance_name
    for kid, leaf, key in (("K1", False, "protein freq"),
                           ("K2", True, "protein leaf")):
        inst, res = instance_name(22, leaf), timing[key]
        kernels.append({
            "name": f"talco_xdrop {inst} ({kid}: {key}, padlen 2048)",
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": protein["prot20k"]["forced"]["by_instance"].get(
                inst, 0),
            "max_abs_err": parity_err, "ms": res["ms_per_pair_resident"],
            "plain_ms": res["plain_ms_per_pair"],
            "bound_ms": res["bound_ms_per_pair"],
            "bound_by": res["bound_by"], "library_ms": None,
            "unit": "per pair", "us_per_diagonal": res["us_per_diagonal"],
            "launches_prot5k_workflow": protein["workflow"][
                "by_instance"].get(inst, 0)})
    from twilight_tpu_torch.tools import talco_inputs as ti
    for fn, kid, replaces, main_variant, ops, layout in PROBES:
        vs = {r["name"]: r for r in probes.values()
              if r["layout"] == layout
              and r["name"].split("/")[0].split("+")[0] == fn}
        r = vs[main_variant]
        b_ms, b_by = ti.bound_ms(ops, 0)
        where = ("one cluster of 8 CTAs" if layout == "cluster"
                 else "one block")
        kernels.append({
            "name": f"probe_loop {fn} ({kid}, {where}; ms of "
                    f"{main_variant})",
            "route": "cuda", "source": PROBE_SOURCE, "replaces": replaces,
            "launches": probe_launches[fn][layout],
            "max_abs_err": max(v["max_abs_err"] for v in vs.values()),
            "ms": r["ns_per_step"] * 1e-6,
            "plain_ms": r["plain_ns_per_step"] * 1e-6,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "unit": "per loop step", "layout": layout,
            "ns_per_step": {n: v["ns_per_step"] for n, v in vs.items()}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ok, flush=True)
    return 0


def _descendants():
    """{pid: (state, command line)} of every process below this one."""
    parent, state = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        parent[int(entry)], state[int(entry)] = int(fields[1]), fields[0]
    found, frontier = {}, {os.getpid()}
    while frontier:
        frontier = {pid for pid, pp in parent.items() if pp in frontier}
        for pid in frontier:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(
                        errors="replace").strip()
            except OSError:
                cmd = ""
            found[pid] = (state[pid], cmd or "?")
    return found


def adopt_orphans():
    """Make this process the reaper of every process started below it
    (Linux PR_SET_CHILD_SUBREAPER), so that an orphaned grandchild stays
    in reach of stop_descendants."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:
        print("chip_smoke: PR_SET_CHILD_SUBREAPER failed (errno "
              f"{ctypes.get_errno()})", file=sys.stderr)


def stop_descendants(grace_s=5.0):
    """Leave no process behind. Closes the multiprocessing resource
    tracker's pipe (the spawn pool started the tracker; it exits at end of
    file), gives every process below this one `grace_s` to end, then sends
    SIGTERM, 3 s later SIGKILL, and reaps each one that is a child. Each
    process that had to be signalled is named on stderr."""
    import signal
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        fd, tracker._fd = tracker._fd, None
    if fd is not None:
        os.close(fd)
    signalled, first = {}, True
    t0 = time.time()
    while True:
        live = {}
        for pid, (state, cmd) in _descendants().items():
            if state == "Z":
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass    # a live descendant's child: its parent reaps it
            else:
                live[pid] = cmd
        if not live:
            return
        if first:
            first = False
            print("chip_smoke: waiting for the processes still running "
                  "below this one: " + "; ".join(
                      f"{pid} ({cmd[:200]})" for pid, cmd in live.items()),
                  file=sys.stderr, flush=True)
        waited = time.time() - t0
        if waited > grace_s:
            sig = signal.SIGKILL if waited > grace_s + 3 else signal.SIGTERM
            for pid, cmd in live.items():
                if signalled.get(pid) != sig:
                    signalled[pid] = sig
                    print(f"chip_smoke: process {pid} ({cmd[:300]}) still "
                          f"running at the end; sending {sig.name}",
                          file=sys.stderr, flush=True)
                    try:
                        os.kill(pid, sig)
                    except ProcessLookupError:
                        pass
        time.sleep(0.05)


if __name__ == "__main__":
    adopt_orphans()
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        rc = 1
    finally:
        stop_descendants()
    sys.exit(rc)
