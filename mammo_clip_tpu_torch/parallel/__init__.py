"""Parallelism over ``torch.distributed`` (port of ``mammo_clip_tpu/parallel/``):
the gathered contrastive losses (``shard_loss``), the collectives of tensor,
sequence and pipeline parallelism and ZeRO-3 as autograd Functions
(``tensor``), the placement rules and ``shard_train_state``
(``partitioning``), BERT's sequence sharding (``constraint``), the GPipe
text tower (``pipeline``) and the N-ranks-equal-one-process dry run
(``dryrun``)."""

from .constraint import MODEL_AXIS, shard_seq
from .pipeline import (pipe_axes, pipeline_apply, pipeline_rows, pipelined_bert_hidden,
                       stack_layer_params)

__all__ = ["MODEL_AXIS", "shard_seq", "pipe_axes", "pipeline_apply", "pipeline_rows",
           "pipelined_bert_hidden", "stack_layer_params"]
