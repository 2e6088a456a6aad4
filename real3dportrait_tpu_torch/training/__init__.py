"""Training: the GAN task of the SECC-to-plane stage, its losses, optimiser
and loop (port of ``real3dportrait_tpu/training``)."""
