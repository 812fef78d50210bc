"""Data parallelism over ``torch.distributed`` (port of the data-parallel part
of ``mammo_clip_tpu/parallel/``): the gathered contrastive losses
(``shard_loss``) and the N-ranks-equal-one-process dry run (``dryrun``).
Tensor parallelism, FSDP, sequence parallelism and the pipeline are the next
slice of the port."""
