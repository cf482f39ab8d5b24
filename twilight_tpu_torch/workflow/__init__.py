"""Workflow layer: iterative tree-estimation + alignment pipelines.

The reference's Snakemake workflow (TWILIGHT workflow/Snakefile:1-188,
rules/twilight.smk) as a library: instead of shelling out to external tree
tools (maffttree/parttree/fasttree/rapidnj/iqtree/raxml/mashtree), tree
estimation is built in (twilight_tpu_torch.trees — k-mer sketch distances
for iteration 0, MSA p-distances after; NJ/PartTree construction), with
its distance products on the GPU under --backend cuda. The reference's
placement mode additionally needs epa-ng + gappa, which are external
binaries; this module's placement entry uses TWILIGHT's own PLACE_W_TREE
alignment path with a built-in nearest-leaf graft instead.

    python -m twilight_tpu_torch.workflow -i seqs.fa -o out.aln [-n 3]
    python -m twilight_tpu_torch.workflow -i new.fa -a backbone.aln \\
        [-t backbone.nwk] -o out.aln [-n 2]
"""
from .iterative import run_iterative

__all__ = ["run_iterative"]
