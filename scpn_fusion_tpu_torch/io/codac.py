"""CODAC-style plant control gateway: shot state machine + command schema.

Role-parity with the reference's control-system connector
(``control/codac_interface.py``: an ITER-CODAC-shaped pulse state machine
gating which commands the physics/control stack will accept in each shot
phase, with abort paths and an event log).  Host-side supervisory logic —
deliberately NOT jitted: this layer sequences compiled programs, it is not
inside them.

Fail-closed semantics: unknown commands, out-of-phase commands, and
illegal transitions raise or route to ABORTED; every decision is appended
to the event log for the evidence trail.
"""

from __future__ import annotations

import dataclasses
import time
from enum import Enum


class PulseState(Enum):
    IDLE = "idle"
    PLASMA_INIT = "plasma_init"
    RAMP_UP = "ramp_up"
    FLATTOP = "flattop"
    RAMP_DOWN = "ramp_down"
    TERMINATED = "terminated"
    ABORTED = "aborted"


# Legal forward transitions (abort is reachable from any live state).
_TRANSITIONS = {
    PulseState.IDLE: (PulseState.PLASMA_INIT,),
    PulseState.PLASMA_INIT: (PulseState.RAMP_UP,),
    PulseState.RAMP_UP: (PulseState.FLATTOP, PulseState.RAMP_DOWN),
    PulseState.FLATTOP: (PulseState.RAMP_DOWN,),
    PulseState.RAMP_DOWN: (PulseState.TERMINATED,),
    PulseState.TERMINATED: (PulseState.IDLE,),
    PulseState.ABORTED: (PulseState.IDLE,),
}

# Which command classes each phase accepts.
_ALLOWED_COMMANDS = {
    PulseState.IDLE: {"configure", "arm"},
    PulseState.PLASMA_INIT: {"gas_puff", "loop_voltage"},
    PulseState.RAMP_UP: {"ip_target", "gas_puff", "heating", "shape"},
    PulseState.FLATTOP: {"ip_target", "gas_puff", "heating", "shape",
                         "seeding"},
    PulseState.RAMP_DOWN: {"ip_target", "gas_puff", "heating"},
    PulseState.TERMINATED: set(),
    PulseState.ABORTED: set(),
}


class CodacError(RuntimeError):
    pass


@dataclasses.dataclass
class PulseGateway:
    """Supervisory gateway: phase transitions + command admission."""

    state: PulseState = PulseState.IDLE
    events: list = dataclasses.field(default_factory=list)
    abort_reason: str | None = None

    def _log(self, kind: str, detail: str) -> None:
        self.events.append({"t": time.time(), "kind": kind,
                            "state": self.state.value, "detail": detail})

    def transition(self, target: PulseState) -> PulseState:
        """Advance the pulse phase; illegal transitions raise."""
        if target is PulseState.ABORTED:
            return self.abort("explicit abort request")
        if target not in _TRANSITIONS[self.state]:
            self._log("transition_rejected", f"{self.state.value} -> "
                                             f"{target.value}")
            raise CodacError(
                f"illegal transition {self.state.value} -> {target.value}")
        self._log("transition", f"-> {target.value}")
        self.state = target
        return self.state

    def abort(self, reason: str) -> PulseState:
        """Abort path is reachable from every live state."""
        if self.state in (PulseState.TERMINATED, PulseState.ABORTED):
            self._log("abort_ignored", reason)
            return self.state
        self._log("abort", reason)
        self.state = PulseState.ABORTED
        self.abort_reason = reason
        return self.state

    def admit(self, command: str, payload: dict | None = None) -> dict:
        """Admit or reject a command for the current phase (fail-closed)."""
        known = set().union(*_ALLOWED_COMMANDS.values())
        if command not in known:
            self._log("command_unknown", command)
            raise CodacError(f"unknown command {command!r}")
        if command not in _ALLOWED_COMMANDS[self.state]:
            self._log("command_rejected", command)
            return {"accepted": False, "command": command,
                    "state": self.state.value,
                    "reason": "not allowed in this phase"}
        self._log("command_accepted", command)
        return {"accepted": True, "command": command,
                "state": self.state.value, "payload": payload or {}}

    def run_nominal_pulse(self) -> list:
        """Drive the nominal phase sequence; returns visited states."""
        seq = [PulseState.PLASMA_INIT, PulseState.RAMP_UP,
               PulseState.FLATTOP, PulseState.RAMP_DOWN,
               PulseState.TERMINATED]
        visited = [self.state]
        for s in seq:
            visited.append(self.transition(s))
        return visited
