"""The System: one crystal + scalar fields.

Role of the reference systemmod (src/systemmod.f90): hold a Crystal and a
set of loaded fields and track the reference field. All fields of a
system live on one device, chosen when the system is built.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import torch

from .config import resolve_device


@dataclass
class System:
    crystal: object = None
    fields: dict = dfield(default_factory=dict)   # id (int|str) -> Field
    iref: int | None = None                        # reference field id
    aliases: dict = dfield(default_factory=dict)
    device: torch.device = None

    @classmethod
    def from_structure(cls, crystal, device=None):
        """System around a Crystal, with the promolecular density loaded
        as field 0. Runs on cuda unless `device` says otherwise."""
        from .crystal.crystal import Crystal
        from .fields.field import Field

        if not isinstance(crystal, Crystal):
            raise NotImplementedError(
                "structure readers are not ported to the torch package yet; "
                "pass a Crystal")
        s = cls(crystal=crystal, device=resolve_device(device))
        s.fields[0] = Field.promolecular(crystal, name="rho0",
                                         device=s.device)
        return s

    def load_field(self, source, fid=None, name=None, **kw):
        """Load a field from a file path (cube) or an existing Field."""
        from .fields.field import Field

        if fid is None:
            fid = max([k for k in self.fields if isinstance(k, int)],
                      default=0) + 1
        if isinstance(source, Field):
            f = source
        else:
            f = Field.from_file(self.crystal, source, device=self.device,
                                **kw)
        if name:
            f.name = name
            self.aliases[name] = fid
        self.fields[fid] = f
        if self.iref is None or self.iref == 0:
            self.iref = fid
        return fid

    @property
    def ref(self):
        """The reference field (field 0 if nothing else is loaded)."""
        return self.fields[self.iref if self.iref is not None else 0]

    def resolve_fid(self, fid):
        """Resolve a field reference: int id, alias name, or numeric str."""
        if isinstance(fid, str):
            if fid in self.aliases:
                return self.aliases[fid]
            if fid.isdigit():
                return int(fid)
            raise KeyError(f"unknown field {fid!r}")
        return fid

    def field(self, fid):
        return self.fields[self.resolve_fid(fid)]
