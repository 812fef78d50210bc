"""Parallelism over ``torch.distributed`` (port of ``mammo_clip_tpu/parallel/``):
the gathered contrastive losses (``shard_loss``), the collectives of tensor
parallelism and ZeRO-3 as autograd Functions (``tensor``), the placement
rules and ``shard_train_state`` (``partitioning``) and the N-ranks-equal-one-
process dry run (``dryrun``). Sequence parallelism and the pipeline are the
next slice of the port."""
