"""Layered configuration: defaults <- TOML file <- CLI flags.

Counterpart of tidb_tpu/utils/config.py. The port's ``store`` names the
engine: ``cuda`` (the default, one CUDA card) or ``cpu``, the explicit
ask for the CPU that tests make; any other value raises. ``mesh_devices``
above 1 raises: multi-device exchange is not ported (ROADMAP.md queue 1,
item 8), and a mesh accepted and then ignored would be a fault.

Reference: pkg/config/config.go (TOML config, 1,568 LoC) overridden by
cmd/tidb-server flags (main.go:200-262, overrideConfig). The TPU engine
keeps the same three layers over the subset of knobs that exist here;
global sysvar defaults can also be seeded from the file's [variables]
table (the reference persists globals in mysql.global_variables).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class Config:
    host: str = "127.0.0.1"
    port: int = 4000
    # HTTP status/metrics side port (None disables; reference :10080)
    status_port: Optional[int] = None
    # persistence directory: catalog loads from it on boot and snapshots
    # back on graceful shutdown (reference --path / storage bootstrap)
    path: Optional[str] = None
    # the engine: "cuda" (one card) or "cpu"
    store: str = "cuda"
    # mesh size for SPMD sessions (None = single device; above 1 refused)
    mesh_devices: Optional[int] = None
    # background stats loop interval (seconds)
    auto_analyze_interval_s: float = 30.0
    # seed values for GLOBAL sysvars ([variables] table in the TOML)
    variables: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Refuse what the port cannot honour: an engine other than
        ``cuda`` or ``cpu``, and a mesh of more than one device."""
        if self.store not in ("cuda", "cpu"):
            raise ValueError(f"unknown store {self.store!r} (supported: cuda, cpu)")
        if self.mesh_devices is not None and int(self.mesh_devices) > 1:
            raise NotImplementedError(
                f"mesh_devices = {self.mesh_devices}: multi-device exchange is not "
                "ported yet (ROADMAP.md queue 1, item 8)")

    @property
    def device(self) -> str:
        """The torch device the store names."""
        return "cuda" if self.store == "cuda" else "cpu"

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        import tomllib

        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    @classmethod
    def from_dict(cls, raw: Dict) -> "Config":
        cfg = cls()
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys {sorted(unknown)}")
        for k, v in raw.items():
            setattr(cfg, k, v)
        cfg.validate()
        return cfg

    def override(self, **kw) -> "Config":
        """CLI-flag layer: non-None values win over the file."""
        out = dataclasses.replace(self)
        for k, v in kw.items():
            if v is not None:
                setattr(out, k, v)
        out.validate()
        return out

    def apply_variables(self, catalog) -> None:
        """Seed GLOBAL sysvars from the [variables] config table."""
        if not self.variables:
            return
        from tidb_tpu_torch.utils.sysvar import SysVars

        sv = SysVars(catalog.global_sysvars)
        for name, val in self.variables.items():
            sv.set(name, val, scope="global")
