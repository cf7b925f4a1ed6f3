"""Distributed substrate of the port: logical-axis sharding rules and the
tensor-parallel runtime of the serving engine.

Modules:
  sharding          logical-name -> mesh-axis rule translation, contexts and
                    spec inference (the JAX package's rules, copied), and
                    ``local_shard``, which cuts one rank's block
  tensor_parallel   the serving and training layouts a rank holds (whole
                    heads, whole quantization groups), its collectives
                    (those of training differentiable) and the cut of
                    parameters, caches and adapters
  compression       int8 error-feedback mean over an axis (``wire_bytes``)
  pipeline          the GPipe schedule over a "stage" axis
  collective_matmul the ring all-gather and reduce-scatter matmuls
  ring              their one hop around an axis (``batch_isend_irecv``)
"""

from repro_torch.dist import sharding  # noqa: F401
