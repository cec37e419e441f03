"""Uncertainty quantification: Monte Carlo chains + polynomial chaos (port
of ``scpn_fusion_tpu/models/uq/``)."""
