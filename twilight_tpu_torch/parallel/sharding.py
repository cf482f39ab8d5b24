"""Multi-GPU execution of one packed batch: the batch cut over a 1-D
"pairs" mesh of devices.

The port of `twilight_tpu/parallel/sharding.py`. There, one
`jax.sharding.Mesh` with a single "pairs" axis holds the chips, and the
batched TALCO kernel runs under `jax.shard_map`, each chip taking one
contiguous slice of the batch (`P("pairs")`). Here the mesh is a tuple of
`torch.device`s (a device may appear twice: two launch queues on one card),
and the sharded kernel launches `talco_cuda.talco_align` once per slice, on
the slice's device and on a stream of its own, so that two slices on one
card overlap. Pairs are independent, so no collective runs inside a batch.

The batch is in `talco_cuda`'s layout (its module doc): `ints`, `floats`,
`offs`, `ref`, `qry`. A slice keeps its pairs' scratch sizes and rebases
their byte offsets to 0 (the kernel refuses offsets that do not start at 0
and end at the launch's scratch size). On a CPU device a slice runs the
kernel's plain version, as `talco_align` does.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops import talco_cuda


def make_pair_mesh(devices: Optional[Sequence] = None
                   ) -> Tuple[torch.device, ...]:
    """1-D mesh over every visible CUDA device, or over the given devices
    (a list may repeat a device). With no argument and no CUDA device it
    raises: there is no CPU default."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_pair_mesh: no CUDA device "
                               "(torch.cuda.is_available() is false); "
                               "pass the devices, e.g. ['cpu'] * 8")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_pair_mesh: no device given")
    for d in mesh:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"make_pair_mesh: unsupported device {d}")
    return mesh


def pad_batch_to_mesh(n_pairs: int, mesh) -> int:
    """Smallest batch >= n_pairs divisible by the mesh size."""
    size = len(mesh)
    return ((n_pairs + size - 1) // size) * size


def get_sharded_batch_kernel(p: int, marker: int, matrix, mesh):
    """The TALCO kernel over one packed batch cut into len(mesh)
    contiguous shards, shard d on mesh[d]. `matrix` is the f32 [msize,
    msize] substitution matrix (a copy goes to each device). The returned
    function takes (ints, floats, offs, ref, qry) on any one device and
    returns (paths, tail) on that device in input order, after every
    shard has finished. A batch that is not a multiple of the mesh size
    raises, as under shard_map."""
    mesh = make_pair_mesh(mesh)
    mat = torch.as_tensor(matrix, dtype=torch.float32)
    mats = {d: mat.to(d).contiguous() for d in set(mesh)}
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in mesh]

    def sharded(ints, floats, offs, ref, qry):
        b = ref.shape[0]
        n = len(mesh)
        if b % n:
            raise ValueError(f"batch of {b} pairs is not a multiple of the "
                             f"mesh size {n} (pad_batch_to_mesh)")
        per = b // n
        home = ref.device
        offs_host = offs.cpu()
        pending = []
        for d, (dev, stream) in enumerate(zip(mesh, streams)):
            lo, hi = d * per, (d + 1) * per
            # the shard's offsets start at 0 and end at its scratch size
            rebased = offs_host[lo:hi + 1] - offs_host[lo]
            scratch = int(rebased[-1])
            args = (ints[:, lo:hi], floats[:, lo:hi], rebased, ref[lo:hi],
                    qry[lo:hi])
            if dev.type == "cpu":
                i_, f_, o_, r_, q_ = (a.cpu().contiguous() for a in args)
                out = talco_cuda.talco_align(
                    i_, f_, o_, r_, q_, mats[dev], p=p, marker=marker,
                    scratch_bytes=scratch)
                pending.append((out, None))
                continue
            with torch.cuda.device(dev):
                if home.type == "cuda":
                    # the inputs were written on the caller's stream
                    stream.wait_stream(torch.cuda.current_stream(home))
                with torch.cuda.stream(stream):
                    i_, f_, o_, r_, q_ = (
                        a.to(dev, non_blocking=True).contiguous()
                        for a in args)
                    out = talco_cuda.talco_align(
                        i_, f_, o_, r_, q_, mats[dev], p=p, marker=marker,
                        scratch_bytes=scratch)
            pending.append((out, stream))
        for _, stream in pending:
            if stream is not None:
                stream.synchronize()
        paths = torch.cat([out[0].to(home) for out, _ in pending])
        tail = torch.cat([out[1].to(home) for out, _ in pending])
        return paths, tail

    return sharded
