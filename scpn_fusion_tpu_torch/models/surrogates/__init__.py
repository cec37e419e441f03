"""Surrogates (port of ``scpn_fusion_tpu/models/surrogates/``): the MLP and
its Adam training loop, the transport surrogate the transport stepper takes
and the equilibrium surrogate (PCA + MLP) of the neural shape loop."""
