"""Guide-tree estimation (the built-in replacement for the reference
workflow's external tree tools — TWILIGHT workflow/Snakefile + rules/*.smk
drive maffttree/parttree/fasttree/rapidnj/...; this module provides the
same capability without external dependencies).

Pipeline: hashed k-mer count profiles -> pairwise distances (cosine-angle
Mash-like metric; the Gram matrix is one big f32 matmul, which runs on the
GPU when the caller gives a CUDA device and the product passes the gate)
-> neighbor joining (vectorized NumPy, O(n^3), on the host) -> Newick. For
large n, a PartTree-style recursive decomposition keeps NJ instances small
(seed sample -> NJ seeds -> assign members -> recurse).
"""
from .estimate import build_guide_tree, kmer_profiles, pairwise_distances
from .nj import neighbor_joining

__all__ = ["build_guide_tree", "kmer_profiles", "pairwise_distances",
           "neighbor_joining"]
