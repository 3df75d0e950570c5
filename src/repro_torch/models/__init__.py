"""The LM stack (port of ``repro.models``): parameter declarations, blocks,
the decoder-only transformer and its serving steps.  This slice covers the
attention (``attn`` / ``local`` / ``global``) and RG-LRU (``rec``) block
kinds, which carry RecurrentGemma-2B."""
