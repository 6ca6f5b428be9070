"""Multi-device parallelism: SPMD ranks over ``torch.distributed``.

Counterpart of ``whisper_mlx_tpu/parallel/``. The JAX package builds one
``jax.sharding.Mesh`` and lets GSPMD insert the collectives; here each rank
is one process on one device, every rank runs the same program, and the
models call the few collectives they need themselves:

- ``mesh``         ``init_distributed``, ``make_mesh`` (axes ``("dp",
                   "tp")``, tp innermost) and the collectives over an axis
- ``sharding``     whisper's Megatron specs, ``shard_params``,
                   ``shard_batch``
- ``sharding_llm`` Qwen's Megatron specs, ``shard_qwen_params``
- ``memory_plan``  per-device bytes of a sharded Qwen, from meta tensors
- ``launch``       start a function on n ranks as n processes
"""
