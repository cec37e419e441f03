"""File formats (counterparts of ``scpn_fusion_tpu/io``).  Framework-neutral
modules are carried over, not imported: ``geqdsk`` is a copy of
``scpn_fusion_tpu/io/geqdsk.py`` in which only ``geqdsk_from_solution``
differs (it reads the port's tensors), and ``imas_ids`` is a copy of
``scpn_fusion_tpu/io/imas_ids.py`` in which only the import lines and two
lines of ``core_profiles_to_transport_state`` differ (it builds the port's
``TransportState`` of tensors on a ``device``, the card by default);
``disruption_npz`` and ``imas_history`` are copies of
``scpn_fusion_tpu/io/disruption_npz.py`` and ``imas_history.py``, line for
line."""

from scpn_fusion_tpu_torch.io.geqdsk import GEqdsk, read_geqdsk, write_geqdsk  # noqa: F401
