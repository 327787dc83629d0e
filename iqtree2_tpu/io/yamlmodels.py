"""YAML model / datatype definitions (--mdef).

Reference analog: the phylo-yaml library (phylo-yaml/statespace.h, yaml-cpp
vendored lib) — user-defined state spaces with `datatype / state / equate`
keys, and custom substitution models. Schema supported here:

  - datatype: MYTYPE
    state: [A, B, C]
    missing: "?"           # optional (also '-')
    equate: {X: [A, B]}    # ambiguity codes

  - model: MYMODEL
    datatype: MYTYPE       # or DNA/AA/BIN/MORPH
    rates: [r12, r13, ..]  # upper-triangle exchangeabilities (row-major)
    frequencies: [..]      # optional; default estimate
    reversible: true       # false -> full rate matrix `matrix: [[..],..]`

Models registered here become usable in -m strings.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu.data import seqtypes
from iqtree2_tpu.data.seqtypes import SeqType, _build

# global registries consulted by the factory / alignment reader
DATATYPES: dict[str, SeqType] = {}
MODELS: dict[str, dict] = {}


def _build_datatype(d: dict) -> SeqType:
    name = str(d["datatype"]).upper()
    states = [str(s) for s in d["state"]]
    S = len(states)
    rows = [[1.0 if i == j else 0.0 for j in range(S)] for i in range(S)]
    chars = {s: i for i, s in enumerate(states)}
    codes = {tuple([i]): i for i in range(S)}
    # ambiguity codes
    for ch, members in (d.get("equate") or {}).items():
        row = [1.0 if s in [str(m) for m in members] else 0.0
               for s in states]
        rows.append(row)
        chars[str(ch)] = len(rows) - 1
    # unknown code (all states)
    rows.append([1.0] * S)
    unknown = len(rows) - 1
    for ch in (d.get("missing") or "?-"):
        chars[str(ch)] = unknown
    return _build(name, S, rows, chars, unknown_code=unknown,
                  state_chars="".join(states) if
                  all(len(s) == 1 for s in states) else states)


def load_definitions(path: str) -> tuple[list[str], list[str]]:
    """Parse a --mdef YAML file into the global registries.

    Returns (new datatype names, new model names). Needs PyYAML, which
    only --mdef uses."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "--mdef model definitions need PyYAML (the 'yaml' module), "
            "which is not installed") from e
    with open(path) as f:
        docs = yaml.safe_load(f)
    if isinstance(docs, dict):
        docs = [docs]
    dts, mds = [], []
    for d in docs or []:
        if not isinstance(d, dict):
            continue
        if "datatype" in d and "state" in d:
            st = _build_datatype(d)
            DATATYPES[st.name] = st
            dts.append(st.name)
        elif "model" in d:
            MODELS[str(d["model"]).upper()] = d
            mds.append(str(d["model"]).upper())
    return dts, mds


def make_yaml_model(name: str, aln):
    """Instantiate a registered YAML model for an alignment."""
    from iqtree2_tpu.model.subst import GTRModel
    from iqtree2_tpu.model.nonrev import UnrestModel
    d = MODELS[name.upper()]
    S = aln.num_states
    freqs = d.get("frequencies")
    if freqs is not None:
        freqs = np.asarray(freqs, float)
        freqs = freqs / freqs.sum()
    if d.get("reversible", True):
        rates = d.get("rates")
        if rates is None:
            rates = np.ones(S * (S - 1) // 2)
        rates = np.asarray(rates, float)
        if rates.shape[0] != S * (S - 1) // 2:
            raise ValueError(
                f"model {name}: expected {S * (S - 1) // 2} rates for "
                f"{S} states, got {rates.shape[0]}")
        ft = "user" if freqs is not None else \
            str(d.get("freq_type", "estimate"))
        return GTRModel(S, exch_rates=rates, freqs=freqs, freq_type=ft,
                        name=name.upper(),
                        fixed_rates=bool(d.get("fix_rates", True)))
    M = np.asarray(d["matrix"], float)
    if M.shape != (S, S):
        raise ValueError(f"model {name}: matrix must be [{S},{S}]")
    off = np.asarray([M[i, j] for i in range(S) for j in range(S)
                      if i != j])
    return UnrestModel(num_states=S, rates=off, name=name.upper())
