#!/usr/bin/env python3
"""Synthetic-scale build rehearsal: bigger-than-example inputs, no vg data
needed. Generates random chromosomes + SNP VCF + multi-exon GTF, runs the
full build (per-chromosome scatter + combine), reports per-stage timing and
PEAK RSS — the native answer to the reference's >256 GB GCSA2 memory
anchor (``build/build.smk:10-12``) — and finally compiles the combined
graph to tensors and drives the node-sharded counts layout over it.

Usage:
  python scripts/stress_build.py [mbp] [n_variants] [n_genes] [n_samples] [n_chroms] [threads]

Defaults: 10 Mbp, 50k SNPs, 400 genes, 20 samples, 1 chromosome, 1 thread.
The round-2 rehearsal configuration: 100 1000000 4000 100 4 2.
"""

import json
import resource
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# defaults; the __main__ block overrides from argv (kept out of import time
# so other scripts can import gen_inputs)
MBP = 10.0
N_VAR = 50_000
N_GENES = 400
N_SAMPLES = 20
N_CHROMS = 1
THREADS = 1


def log(msg):
    print(f"[stress] {msg}", file=sys.stderr, flush=True)


def rss_gb():
    self_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    child_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    return max(self_rss, child_rss) / 1e6


def gen_inputs(wd: Path, mbp=None, n_var=None, n_genes=None, n_samples=None,
               n_chroms=None, n_exons=5, n_tx=2, seed=11):
    """Write synthetic FA/GTF/VCF into wd (importable; args default to the
    CLI globals so the script behaves as before). ``n_exons``/``n_tx``
    control isoform richness: transcript 1 is the full exon chain, each
    further isoform skips a different internal exon (ES-dense annotation
    for call-stage benchmarks). ``seed`` fixes the sequence, the variant
    positions and the genotypes."""
    import numpy as np

    MBP = mbp if mbp is not None else globals()["MBP"]
    N_VAR = n_var if n_var is not None else globals()["N_VAR"]
    N_GENES = n_genes if n_genes is not None else globals()["N_GENES"]
    N_SAMPLES = n_samples if n_samples is not None else globals()["N_SAMPLES"]
    N_CHROMS = n_chroms if n_chroms is not None else globals()["N_CHROMS"]

    rng = np.random.default_rng(seed)
    L = int(MBP * 1e6) // N_CHROMS
    bases = np.frombuffer(b"ACGT", dtype="S1")

    genes_per_chrom = N_GENES // N_CHROMS
    vars_per_chrom = N_VAR // N_CHROMS

    fa = open(wd / "g.fa", "w")
    gtf = open(wd / "g.gtf", "w")
    vcf = open(wd / "g.vcf", "w")
    vcf.write("##fileformat=VCFv4.2\n")
    vcf.write(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"s{i}" for i in range(N_SAMPLES))
        + "\n"
    )
    alt_of = {"A": "G", "C": "T", "G": "A", "T": "C"}
    for ci in range(N_CHROMS):
        chrom = f"chr{ci}"
        seq_arr = bases[rng.integers(0, 4, size=L)]
        seq = seq_arr.tobytes().decode()
        fa.write(f">{chrom}\n")
        for i in range(0, L, 10000):
            fa.write(seq[i : i + 10000] + "\n")

        span = L // (genes_per_chrom + 1)
        for gi in range(genes_per_chrom):
            gstart = span * (gi + 1)
            exons = [
                (gstart + k * 500 + 1, gstart + k * 500 + 200)
                for k in range(n_exons)
            ]
            for t in range(1, n_tx + 1):
                tid = f"T{ci}_{gi}_{t}"
                if t == 1:
                    ex = exons
                else:  # event-diverse isoforms: ES / A3 / A5 / IR rotation
                    k = 1 + (t - 2) % max(n_exons - 2, 1)
                    kind = (t - 2) % 4
                    if kind == 0:  # exon skipping
                        ex = exons[:k] + exons[k + 1 :]
                    elif kind == 1:  # alternative acceptor (start shifted)
                        s0, e0 = exons[k]
                        ex = exons[:k] + [(s0 + 60, e0)] + exons[k + 1 :]
                    elif kind == 2:  # alternative donor (end shifted)
                        s0, e0 = exons[k]
                        ex = exons[:k] + [(s0, e0 - 60)] + exons[k + 1 :]
                    else:  # intron retention: merge exon k with k+1
                        ex = (
                            exons[:k]
                            + [(exons[k][0], exons[k + 1][1])]
                            + exons[k + 2 :]
                        )
                gtf.write(
                    "\t".join(
                        [chrom, "s", "transcript", str(ex[0][0]), str(ex[-1][1]),
                         ".", "+", ".",
                         f'gene_id "G{ci}_{gi}"; transcript_id "{tid}";']) + "\n")
                for s, e in ex:
                    gtf.write(
                        "\t".join(
                            [chrom, "s", "exon", str(s), str(e), ".", "+", ".",
                             f'gene_id "G{ci}_{gi}"; transcript_id "{tid}";']) + "\n")

        positions = np.sort(
            rng.choice(np.arange(1, L + 1), size=vars_per_chrom, replace=False)
        )
        # genotype block: 1000G-like allele frequency mix
        afs = rng.choice([0.02, 0.05, 0.15, 0.4], size=vars_per_chrom)
        h = rng.random((vars_per_chrom, 2 * N_SAMPLES)) < afs[:, None]
        gt_chars = np.where(h, "1", "0")
        for vi, pos in enumerate(positions):
            ref = seq[pos - 1]
            row = gt_chars[vi]
            gts = "\t".join(
                row[2 * s] + "|" + row[2 * s + 1] for s in range(N_SAMPLES)
            )
            vcf.write(f"{chrom}\t{pos}\tv{ci}_{vi}\t{ref}\t{alt_of[ref]}\t.\t.\t.\tGT\t{gts}\n")
    fa.close()
    gtf.close()
    vcf.close()


def main():
    import tempfile

    wd = Path(tempfile.mkdtemp(prefix="stress_"))
    log(
        f"generating {MBP} Mbp over {N_CHROMS} chroms, {N_VAR} variants, "
        f"{N_GENES} genes, {N_SAMPLES} samples -> {wd}"
    )
    t0 = time.time()
    gen_inputs(wd)
    gen_s = time.time() - t0
    log(f"inputs: {gen_s:.1f}s (RSS {rss_gb():.1f} GB)")

    from pantas_tpu.build.pipeline import build_pangenome

    t0 = time.time()
    out = build_pangenome(
        str(wd / "g.fa"), str(wd / "g.gtf"), str(wd / "g.vcf"),
        str(wd / "out"), threads=THREADS,
    )
    dt = time.time() - t0
    n_s = n_l = n_p = 0
    for line in open(out):
        c = line[0]
        n_s += c == "S"
        n_l += c == "L"
        n_p += c == "P"
    size_gb = Path(out).stat().st_size / 1e9
    log(
        f"build: {dt:.1f}s — {n_s} nodes, {n_l} edges, {n_p} paths, "
        f"{size_gb:.2f} GB GFA ({MBP / dt:.2f} Mbp/s), peak RSS {rss_gb():.1f} GB"
    )

    # node-sharded counts layout over the real graph (8 virtual devices)
    import os

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from pantas_tpu.graph.compiler import compile_gfa
    from pantas_tpu.parallel.mesh import (
        coverage_mesh_2d,
        node_sharded_scatter_add,
        pad_to_multiple,
    )

    t0 = time.time()
    tensors = compile_gfa(out)
    log(f"tensorize: {time.time() - t0:.1f}s — {tensors.total_slots} count slots")
    mesh = coverage_mesh_2d(jax.devices()[:8], 2, 4)
    step, shard = node_sharded_scatter_add(mesh, tensors.total_slots)
    import jax.numpy as jnp

    counts = jnp.zeros((2, shard * 4), dtype=jnp.int32)  # private partials
    rng = np.random.default_rng(0)
    idx = jnp.asarray(pad_to_multiple(
        rng.integers(0, tensors.total_slots, size=1 << 22, dtype=np.int32), 2
    ))
    t0 = time.time()
    stepped = step(counts, idx)
    stepped.block_until_ready()
    log(f"node-sharded scatter (2x4 mesh, 4M idx): {time.time() - t0:.1f}s")

    print(json.dumps({
        "mbp": MBP, "variants": N_VAR, "samples": N_SAMPLES,
        "chroms": N_CHROMS, "threads": THREADS,
        "gen_s": round(gen_s, 1), "build_s": round(dt, 1),
        "mbp_per_s": round(MBP / dt, 2), "nodes": n_s, "edges": n_l,
        "paths": n_p, "gfa_gb": round(size_gb, 2),
        "peak_rss_gb": round(rss_gb(), 1),
        "slots": int(tensors.total_slots),
    }))


if __name__ == "__main__":
    MBP = float(sys.argv[1]) if len(sys.argv) > 1 else MBP
    N_VAR = int(sys.argv[2]) if len(sys.argv) > 2 else N_VAR
    N_GENES = int(sys.argv[3]) if len(sys.argv) > 3 else N_GENES
    N_SAMPLES = int(sys.argv[4]) if len(sys.argv) > 4 else N_SAMPLES
    N_CHROMS = int(sys.argv[5]) if len(sys.argv) > 5 else N_CHROMS
    THREADS = int(sys.argv[6]) if len(sys.argv) > 6 else THREADS
    main()
