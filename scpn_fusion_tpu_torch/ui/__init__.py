"""Dashboard / reporting surface (markdown generator; no GUI deps)."""

from scpn_fusion_tpu_torch.ui.dashboard import generate_dashboard

__all__ = ["generate_dashboard"]
