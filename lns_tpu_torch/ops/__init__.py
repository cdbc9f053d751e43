"""Neural building blocks on NCHW tensors in channels-last memory: norms,
activations, padded convs, residual / resampling blocks, self-attention and
factorized axial attention."""
