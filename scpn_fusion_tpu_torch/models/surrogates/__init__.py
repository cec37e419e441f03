"""Surrogates (port of ``scpn_fusion_tpu/models/surrogates/``): so far the
MLP forward pass and the transport surrogate the transport stepper takes."""
