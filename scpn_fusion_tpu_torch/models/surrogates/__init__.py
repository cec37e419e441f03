"""Surrogates (port of ``scpn_fusion_tpu/models/surrogates/``): the MLP and
its Adam training loop, the FNO and its multi-regime data, the equilibrium
surrogate (PCA + MLP), the ESN oracle, the heat-shadow and QLKNN
surrogates, the GyroSwin surrogate with the GENE-like proxy (row W), the
turbulence-suppression loop and the committed artifacts with their
trainers.  Exports the names the JAX package's ``__init__`` exports."""

from scpn_fusion_tpu_torch.models.surrogates.mlp import (  # noqa: F401
    MLPParams,
    init_mlp,
    mlp_apply,
    train_mlp,
)
from scpn_fusion_tpu_torch.models.surrogates.fno import (  # noqa: F401
    FNOParams,
    fno_apply,
    init_fno,
    train_fno,
)
from scpn_fusion_tpu_torch.models.surrogates.equilibrium_surrogate import (  # noqa: F401
    EquilibriumSurrogate,
    train_equilibrium_surrogate,
)
from scpn_fusion_tpu_torch.models.surrogates.esn import (  # noqa: F401
    ESNParams,
    ESNReadout,
    fit_esn,
    init_esn,
    predict_closed_loop,
    trust_horizon,
)
from scpn_fusion_tpu_torch.models.surrogates.heat_shadow import (  # noqa: F401
    fit_shadow_surrogate,
    fit_synthetic as fit_heat_shadow_synthetic,
    predict_divertor_flux,
    predict_shadow_fraction,
)
from scpn_fusion_tpu_torch.models.surrogates.qlknn import (  # noqa: F401
    QLKNNModel,
    analytic_targets as qlknn_analytic_targets,
    electron_collisionality_star,
    predict_fluxes as qlknn_predict_fluxes,
    qlknn_features_from_profiles,
    train_qlknn,
)
