"""The LM stack (port of ``repro.models``): parameter declarations and their
sharding rules, the activation-sharding context, blocks, the decoder-only
transformer and its train and serving steps.  This slice covers the
attention (``attn`` / ``local`` / ``global``) and RG-LRU (``rec``) block
kinds, which carry RecurrentGemma-2B."""
