"""Nuclear engineering: breeding blanket neutronics, plasma-wall erosion,
the TEMHD layer, wall loading and the heating/neutronics candidates (port of
``scpn_fusion_tpu/models/nuclear/``).  The blanket's group solves and every
TEMHD step run row T on the card (``ops/tridiag.py``)."""
from scpn_fusion_tpu_torch.models.nuclear.temhd import (  # noqa: F401
    TEMHDParams,
    run_temhd,
    temhd_flux_scan,
)
from scpn_fusion_tpu_torch.models.nuclear.wall_loading import (  # noqa: F401
    WallGeometry,
    analyze_material,
    ash_poisoning_dilution,
    compute_wall_loading,
    neutron_source_density,
)
from scpn_fusion_tpu_torch.models.nuclear.heating_neutronics import (  # noqa: F401
    aries_at_q_proxy,
    genray_heating_proxy,
    mcnp_lite_tbr,
    mcnp_lite_transport_tbr,
    quick_candidate,
    refine_candidate_tbr,
)
