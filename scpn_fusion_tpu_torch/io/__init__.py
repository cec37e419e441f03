"""File formats (counterparts of ``scpn_fusion_tpu/io``), exporting what
``scpn_fusion_tpu/io/__init__.py`` exports.  Framework-neutral modules are
carried over, not imported: ``geqdsk`` is a copy of
``scpn_fusion_tpu/io/geqdsk.py`` in which only ``geqdsk_from_solution``
differs (it reads the port's tensors), and ``imas_ids`` is a copy of
``scpn_fusion_tpu/io/imas_ids.py`` in which only the import lines and two
lines of ``core_profiles_to_transport_state`` differ (it builds the port's
``TransportState`` of tensors on a ``device``, the card by default);
``disruption_npz``, ``imas_history``, ``archive``, ``codac``, ``imas``,
``mast`` and ``omas_inputs`` are copies of their JAX package's files, line
for line but the import lines (``archive`` and ``mast`` record their
fallbacks in the port's own ``utils.telemetry``)."""

from scpn_fusion_tpu_torch.io.archive import (  # noqa: F401
    MachineProfiles,
    fetch_mdsplus_profiles,
    load_machine_profiles,
    poll_feed,
    save_reference_profiles,
    synthetic_machine_profiles,
)
from scpn_fusion_tpu_torch.io.geqdsk import GEqdsk, read_geqdsk, write_geqdsk  # noqa: F401
from scpn_fusion_tpu_torch.io.imas import (  # noqa: F401
    IdsError,
    equilibrium_to_ids,
    ids_from_json,
    ids_get,
    ids_new,
    ids_put,
    ids_to_equilibrium,
    ids_to_json,
    ids_to_profiles,
    profiles_to_ids,
)
from scpn_fusion_tpu_torch.io.imas_history import (  # noqa: F401
    ids_pulse_to_twin_history,
    ids_to_twin_history,
    twin_history_to_ids,
    twin_history_to_ids_pulse,
    validate_ids_pulse_payload,
    validate_ids_payload_sequence,
)
