# Training substrate of ``repro.train``: the masked-diffusion loss, AdamW,
# checkpoints and the fault-tolerant train loop, as torch ops under autograd.
