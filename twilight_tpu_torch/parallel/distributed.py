"""Multi-host execution: dispatch divide-and-conquer subtrees across hosts.

The port of `twilight_tpu/parallel/distributed.py`, with torch.distributed
in place of jax.distributed. The reference processes subtrees SEQUENTIALLY
in one process (TWILIGHT src/twilight-main.cpp:139-176) and merges through
temp files + `cat` (io.cpp:465-488). Here every host partitions the guide
tree the same way, takes its share of the subtrees by leaf count (largest
first), aligns them on its own GPUs, and then the subtree-root profiles
and lengths travel either by an all-gather over a gloo group (when a
torch.distributed default group is initialized) or through the shared
temp dir's checkpoint files (the same .state.npz files --resume uses).
Host 0 runs the merge pass and writes the final MSA.

Usage (one command per host):
    python -m twilight_tpu_torch ... -m N --hosts H --host-id I -d shared_tmp
Inside a process that has called torch.distributed.init_process_group
(the caller gives its address, world size and rank), H and I default to
the group's world size and rank.

The exchanged payload is host bytes, so it always rides gloo: NCCL needs
CUDA tensors, and two ranks on one GPU cannot share an NCCL communicator.
A failure of a live group raises; no host carries on as if it ran alone.

torch is imported by the functions that use a group. A process that never
imported torch has no group, so a host-only run over the shared temp dir
imports none (the command line's front door).
"""
from __future__ import annotations

import io
import os
import sys
import time
from typing import List, Sequence, Tuple

import numpy as np

# gloo groups made for a default group of another backend, by that group
_gloo_groups: dict = {}


def assign_subtrees(sizes: Sequence[Tuple[str, int]], n_hosts: int
                    ) -> List[List[str]]:
    """Greedy balanced assignment: sort subtrees by leaf count descending,
    give each to the currently least-loaded host. Deterministic (ties break
    by subtree name) so every host computes the same assignment without
    communication."""
    order = sorted(sizes, key=lambda kv: (-kv[1], kv[0]))
    loads = [0] * n_hosts
    out: List[List[str]] = [[] for _ in range(n_hosts)]
    for name, cnt in order:
        h = min(range(n_hosts), key=lambda i: (loads[i], i))
        out[h].append(name)
        loads[h] += cnt
    return out


def detect_topology(args_hosts: int = 0, args_host_id: int = -1
                    ) -> Tuple[int, int]:
    """(n_hosts, host_id) from flags, else an initialized torch.distributed
    default group, else (1, 0)."""
    if args_hosts > 0:
        if args_host_id >= 0:
            if args_host_id >= args_hosts:
                raise ValueError(f"--host-id {args_host_id} is not below "
                                 f"--hosts {args_hosts}")
            return args_hosts, args_host_id
        if args_hosts == 1:
            return 1, 0
        n, rank = detect_topology_implicit()
        if n == args_hosts:
            return n, rank
        raise ValueError(
            "--hosts N > 1 requires --host-id (or an initialized "
            "torch.distributed default group with a matching world size): "
            "defaulting every process to host 0 would compute only host "
            "0's subtree shard and hang the exchange barrier")
    return detect_topology_implicit()


def detect_topology_implicit() -> Tuple[int, int]:
    """(n_hosts, host_id) from an already-initialized torch.distributed
    default group; (1, 0) otherwise. Never creates a group: the caller
    initializes one (init_process_group) when it runs several hosts."""
    if "torch" not in sys.modules:
        return 1, 0
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def distributed_live() -> bool:
    """True when an initialized torch.distributed group spans >1 process."""
    n, _ = detect_topology_implicit()
    return n > 1


def _gloo_group():
    """The group the exchange runs on: the default group when it is gloo,
    else a gloo group over the same ranks, made once (collective: every
    rank reaches this point in the same order)."""
    import torch.distributed as dist
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _gloo_groups:
        _gloo_groups[world] = dist.new_group(backend="gloo")
    return _gloo_groups[world]


def exchange_subtree_states_collective(local: dict) -> dict:
    """All-gather per-subtree root states across hosts over gloo.

    `local` maps subtree id -> {msa_freq, aln_len, aln_num, aln_weight} for
    the subtrees THIS host computed. Profiles are ragged ([len, P] f32, one
    per subtree), so each host serializes its dict to one npz byte blob;
    blob lengths (int64) are all-gathered first, then the zero-padded
    uint8 blobs, as CPU tensors. Every host gets every subtree's root state
    without touching the filesystem. The bulk subalignment FASTAs still
    live in the shared temp dir (they are the checkpoint/restart path and
    are only streamed once by host 0's transitivity writer).

    Collective: must be called by ALL processes of the default group. Acts
    as the barrier that guarantees every host's subalignment files are
    fully written (each host writes them before reaching this point).
    """
    import torch
    import torch.distributed as dist
    group = _gloo_group()
    world = dist.get_world_size()
    buf = io.BytesIO()
    np.savez(buf, **{f"{sid}:{key}": np.asarray(val)
                     for sid, st in local.items()
                     for key, val in st.items()})
    payload = np.frombuffer(buf.getvalue(), dtype=np.uint8)
    size = torch.tensor([payload.size], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, size, group=group)
    longest = max(int(s[0]) for s in sizes)
    padded = torch.zeros(longest, dtype=torch.uint8)
    padded[:payload.size] = torch.from_numpy(payload.copy())
    blobs = [torch.empty(longest, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(blobs, padded, group=group)
    merged: dict = {}
    for h in range(world):
        blob = blobs[h][:int(sizes[h][0])].numpy().tobytes()
        if not blob:
            continue
        z = np.load(io.BytesIO(blob))
        for k in z.files:
            sid, key = k.rsplit(":", 1)
            merged.setdefault(int(sid), {})[key] = z[k]
    return merged


def exchange_subtree_states(option, subtree_ids: Sequence[int],
                            timeout_s: float = 3600.0) -> None:
    """Barrier until every subtree's checkpoint exists in the shared temp
    dir. The .state.npz + subalignment files written per subtree ARE the
    exchanged payload (shared-FS collective); when a torch.distributed
    group is live, every host first meets at a gloo barrier, so that no
    host races ahead of the slowest writer (a failed barrier raises)."""
    if distributed_live():
        import torch.distributed as dist
        dist.barrier(group=_gloo_group())
    deadline = time.time() + timeout_s
    missing = list(subtree_ids)
    while missing:
        missing = [
            s for s in missing
            if not (os.path.exists(os.path.join(
                option.temp_dir, f"subtree-{s}.state.npz")))]
        if not missing:
            break
        if time.time() > deadline:
            raise TimeoutError(
                f"subtree checkpoints never appeared: {missing}")
        time.sleep(1.0)
