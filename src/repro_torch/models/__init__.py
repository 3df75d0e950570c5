"""The LM stack (port of ``repro.models``): parameter declarations and their
sharding rules, the activation-sharding context, blocks, the decoder-only
transformer and its train and serving steps.  It has every decoder-only
block kind of the JAX package: attention (``attn`` / ``local`` /
``global``), MoE (``moe``), MLA (``mla`` / ``mla_moe``), RG-LRU (``rec``)
and xLSTM (``mlstm`` / ``slstm``)."""
