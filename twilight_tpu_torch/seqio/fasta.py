"""FASTA reading/writing (plain and gzip).

Read semantics follow klib kseq as used by the reference (io.cpp:14,55-98):
records delimited by '>', name = text up to first whitespace... note the
reference matches tree leaves first on the FULL header and then on the
name-up-to-first-blank (io.cpp:75-78), so we keep both.
"""
from __future__ import annotations

import gzip
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Tuple

from .. import trace


@dataclass
class FastaRecord:
    name: str        # up to first whitespace
    full_name: str   # entire header line (minus '>') up to first whitespace...
    seq: str


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    # fall back to gzip sniffing like kseq/gzread: gzopen reads plain files too
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


def iter_fasta(path: str) -> Iterator[Tuple[str, str, str]]:
    """Yield (name, full_header, sequence).

    kseq parses name as chars up to first whitespace and the rest as comment;
    the reference uses `kseq->name.s` (no comment) as seqName_full, so 'name'
    and 'full_name' only differ if the header has embedded spaces — in that
    case full_name is the first token too (kseq name stops at isspace).
    """
    name = None
    chunks: List[str] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if name is not None:
                    yield name, name, "".join(chunks)
                header = line[1:]
                # kseq: name = up to first whitespace
                name = header.split(None, 1)[0] if header.strip() else ""
                chunks = []
            elif line.startswith("+") and name is None:
                continue
            else:
                if name is not None:
                    chunks.append(line.strip())
    if name is not None:
        yield name, name, "".join(chunks)


def read_fasta(path: str) -> List[Tuple[str, str]]:
    return [(n, s) for n, _, s in iter_fasta(path)]


def read_names(path: str) -> List[str]:
    return [n for n, _, _ in iter_fasta(path)]


def _gzip_member(payload: bytes) -> bytes:
    """One complete gzip member per record, matching the reference writer
    (io.cpp:17-35, per-sequence gzip chunks)."""
    co = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, 15 + 16)
    return co.compress(payload) + co.flush()


def write_fasta(path: str, records: List[Tuple[str, str]], compressed: bool = False,
                append: bool = False) -> None:
    written = 0
    if compressed:
        path = path + ".gz"
        mode = "ab" if append else "wb"
        # per-record gzip members, compressed in parallel and written in
        # order (reference io.cpp:493-509 compresses per-sequence chunks
        # under a TBB parallel_for; zlib releases the GIL so threads scale)
        import os as _os
        workers = min(_os.cpu_count() or 1, 16)
        with open(path, mode) as f:
            if workers > 1 and len(records) > 8:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    for member in ex.map(
                            lambda r: _gzip_member(
                                (">" + r[0] + "\n" + r[1] + "\n").encode()),
                            records, chunksize=8):
                        written += f.write(member)
            else:
                for name, seq in records:
                    written += f.write(_gzip_member(
                        (">" + name + "\n" + seq + "\n").encode()))
    else:
        mode = "a" if append else "w"
        with open(path, mode) as f:
            for name, seq in records:
                written += f.write(">" + name + "\n" + seq + "\n")
    trace.count("bytes_written", written)
