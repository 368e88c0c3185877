"""A configuration file's codec parameters, for the reference and for the
program.

``params`` holds the fields of ``struct cmp_params`` (lib/cmp.h:94-116)
with the enumerations by name; ``batch`` and ``samples`` the B x N frame
shape; ``cmp_type`` the sample layout (only ``U16`` is covered).
"""

from __future__ import annotations

from .reference import airspace

__all__ = ["reference_params", "program_params", "chain_cycle",
           "header_bytes"]

PREPROCESSING = {"NONE": 0, "DIFF": 1, "IWT": 2, "MODEL": 3}
ENCODER = {"UNCOMPRESSED": 0, "GOLOMB_ZERO": 1, "GOLOMB_MULTI": 2}
_ENUMS = {"primary_preprocessing": PREPROCESSING,
          "secondary_preprocessing": PREPROCESSING,
          "primary_encoder_type": ENCODER,
          "secondary_encoder_type": ENCODER}


def _numeric(cfg: dict) -> dict:
    if cfg.get("cmp_type", "U16") != "U16":
        raise ValueError(f"cmp_type {cfg['cmp_type']} is not covered")
    return {k: (_ENUMS[k][v] if k in _ENUMS else v)
            for k, v in cfg["params"].items()}


def reference_params(cfg: dict) -> airspace.Params:
    return airspace.Params(**_numeric(cfg))


def program_params(cfg: dict, program):
    """The program's ``CmpParams`` (``program``: its imported package)."""
    kw = _numeric(cfg)
    for key in ("primary_preprocessing", "secondary_preprocessing"):
        kw[key] = program.Preprocessing(kw[key])
    for key in ("primary_encoder_type", "secondary_encoder_type"):
        kw[key] = program.EncoderType(kw[key])
    return program.CmpParams(**kw)


def chain_cycle(cfg: dict) -> int:
    """Batches from one primary pass to the next."""
    return 1 + int(cfg["params"].get("secondary_iterations", 0))


def header_bytes(cfg: dict, secondary: bool) -> int:
    """16, or 22 with the extension (any preprocessing or encoder)."""
    side = "secondary" if secondary else "primary"
    p = cfg["params"]
    plain = (p.get(f"{side}_preprocessing", "NONE") == "NONE"
             and p.get(f"{side}_encoder_type", "UNCOMPRESSED")
             == "UNCOMPRESSED")
    return 16 if plain else 22
