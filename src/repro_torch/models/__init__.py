"""The LM stack: functional code over parameter dicts of tensors.

common     dtype policy, inits, RMSNorm, rotary embeddings, activations
mlp        gated feed-forward (SwiGLU / GeGLU)
attention  GQA attention: prefill and train through the hand-written flash
           kernel (``kernels.ops.flash_attention``), decode in plain torch
mamba      Mamba-2 (SSD) mixers: chunked prefill, recurrent decode
moe        mixture of experts: sort dispatch over the real rows, aux losses
blocks     the period decomposition of the layer stack, one decoder block
lm         embeddings + the period-stacked decoder stack + LM head
convert    the JAX package's parameter trees carried over, bit for bit

Same file, function and parameter-tree names as ``repro/models``, so the
weights of one load into the other by :mod:`convert`.  Every family of
``configs`` builds: dense, local/global, moe, ssm, hybrid, audio, vlm.
"""
