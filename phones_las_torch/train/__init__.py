"""Training layer (port of ``phones_las_tpu/train``): ``state`` (config, Adam with clipping, gradient masking) and ``loop`` (the Trainer)."""
