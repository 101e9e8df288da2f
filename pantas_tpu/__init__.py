"""pantas_tpu — a spliced-pangenome alternative-splicing engine on JAX.

A from-scratch reimplementation of the capabilities of AlgoLab/pantas
(haplotype-aware differential alternative-splicing quantification over an
annotated spliced pangenome), redesigned for accelerators:

- the annotated GFA is compiled into dense node/edge/junction tensors
  (``pantas_tpu.graph``),
- GAF alignment records stream in data-parallel batches whose path walks
  become vectorized scatter-adds onto coverage arrays (``pantas_tpu.coverage``),
- coverage partial sums merge across a ``jax.sharding.Mesh`` via ``psum``
  collectives (``pantas_tpu.parallel``),
- event calling (ES/A3/A5/IR/CE) and PSI quantification run as batched
  gathers/reductions over the junction tensors (``pantas_tpu.events``,
  ``pantas_tpu.quant``).

The pipeline stages mirror the reference CLI 1:1 (build / augment / call /
quant / remap; see reference ``pantas:10-17``) and produce byte-compatible
CSV/GFA artifacts.
"""

__version__ = "0.1.0"
