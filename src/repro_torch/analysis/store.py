"""Offline artifact-store & plan verifier (copy of
``repro.analysis.store``: the same rules, the same findings, over the same
store format).

``verify_store(path)`` validates a ``checkpoint.save_programmed`` store
from its manifest and npz *headers* alone — no arrays are loaded, no model
runs, nothing is device_put — so it is cheap enough to run fail-fast at
every ``ServingEngine(restore_artifacts=)`` construction and offline in CI
against fleet stores.  Checked:

* **store resolution** — slot A/B layout, ``programmed.ACTIVE`` pointer
  (a corrupt or dangling pointer is a finding, not a crash), crash-recovery
  candidates (``.tmp``/``.old``) in the same completeness order
  ``restore_programmed`` uses;
* **manifest schema** — known schema version, required per-artifact keys,
  decodable ``CrossbarSpec`` / ``ADCConfig`` / ``DeviceConfig`` / reports
  (tolerant of pre-planner and pre-lifecycle manifests, which carry no
  ``plan`` / ``device`` / ``t_service_s``);
* **array leaves** — every npz member is a known ``ProgrammedLinear``
  array field, the mandatory fields are present, and (via npz headers)
  ``g_eff`` is (n_slices, K, N)-consistent with ``w_codes`` and the spec;
  ``g_spare``/``out_gather`` travel as a pair;
* **sharding specs** — recorded PartitionSpecs name only known fields and
  fit the array ranks;
* **plan admissibility** — each ``LayerPlan`` decodes (unknown datapath /
  ADC mode fails in ``LayerPlan.__post_init__``), its ADC config matches
  the recorded one, its datapath crossbar factor fits an optional
  ``max_crossbar_factor`` area budget, and its ADC mode satisfies an
  optional ``exactness`` contract;
* **name-set vs a model** — pass ``expected`` (from
  ``device.programmed.expected_artifact_names``) to cross-check the store
  against what a given params tree would program: missing / extra names
  and per-name ``w_codes`` shape mismatches are findings.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Dict, List, Optional, Tuple

REQUIRED_INFO_KEYS = ("file", "spec", "adc_cfg", "fast", "report", "repair")
MANDATORY_ARRAYS = ("w_codes", "w_colsum", "w_scale")
KNOWN_SCHEMAS = (1,)


@dataclasses.dataclass(frozen=True)
class StoreFinding:
    rule: str
    message: str
    name: Optional[str] = None  # artifact name, when the finding is per-leaf

    def format(self) -> str:
        where = f" [{self.name}]" if self.name else ""
        return f"[{self.rule}]{where} {self.message}"


@dataclasses.dataclass
class StoreReport:
    directory: str
    resolved: Optional[str]  # directory actually holding the manifest
    slot: Optional[str]
    findings: List[StoreFinding]
    n_artifacts: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def summary(self) -> str:
        head = (
            f"store {self.directory!r}"
            + (f" (slot {self.slot})" if self.slot else "")
            + f": {self.n_artifacts} artifact(s), "
            + ("OK" if self.ok else f"{len(self.findings)} finding(s)")
        )
        return "\n".join([head] + ["  " + f.format() for f in self.findings])


def _npz_headers(path: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{member: (shape, dtype)} from npz headers — no array data is read."""
    from numpy.lib import format as npformat

    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    with zipfile.ZipFile(path) as z:
        for member in z.namelist():
            if not member.endswith(".npy"):
                continue
            with z.open(member) as f:
                version = npformat.read_magic(f)
                try:
                    shape, _, dtype = npformat._read_array_header(f, version)
                except AttributeError:  # very old numpy: public per-version API
                    reader = {
                        (1, 0): npformat.read_array_header_1_0,
                        (2, 0): npformat.read_array_header_2_0,
                    }[version]
                    shape, _, dtype = reader(f)
            out[member[: -len(".npy")]] = (tuple(shape), str(dtype))
    return out


def _resolve(directory: str, slot: Optional[str], findings: List[StoreFinding]):
    """Mirror ``restore_programmed``'s store resolution, turning pointer
    corruption into findings.  Returns (resolved_dir_or_None, slot)."""
    from repro_torch.checkpoint.checkpoint import PROGRAMMED_SLOTS, _active_pointer

    if slot is None:
        ptr = _active_pointer(directory)
        if os.path.isfile(ptr):
            with open(ptr) as f:
                content = f.read().strip()
            if content not in PROGRAMMED_SLOTS:
                findings.append(StoreFinding(
                    "active-pointer",
                    f"corrupt programmed.ACTIVE pointer: {content!r} is not "
                    f"one of {PROGRAMMED_SLOTS}",
                ))
                return None, None
            slot = content
    if slot is not None:
        base = os.path.join(directory, f"programmed.slot{slot}")
        candidates = [base, base + ".tmp", base + ".old"]
    else:
        base = os.path.join(directory, "programmed")
        candidates = [base, base + ".tmp", base + ".old", directory]
    for c in candidates:
        if os.path.isfile(os.path.join(c, "manifest.json")):
            return c, slot
    if slot is not None:
        findings.append(StoreFinding(
            "active-pointer",
            f"dangling ACTIVE pointer: slot {slot} has no manifest.json "
            f"under {directory!r} (swap_active would have refused this)",
        ))
    else:
        findings.append(StoreFinding(
            "store", f"no programmed-artifact store under {directory!r}"
        ))
    return None, slot


def verify_store(
    directory: str,
    expected: Optional[Dict[str, Tuple[int, ...]]] = None,
    slot: Optional[str] = None,
    max_crossbar_factor: Optional[float] = None,
    exactness: Optional[str] = None,
) -> StoreReport:
    from repro_torch.core.adc import ADCConfig
    from repro_torch.core.crossbar import CrossbarSpec
    from repro_torch.core.planner import adc_config_for, datapath_crossbar_factor
    from repro_torch.checkpoint.checkpoint import _decode_aux, _decode_plan
    from repro_torch.device.models import DeviceConfig
    from repro_torch.device.programmed import ARTIFACT_ARRAY_FIELDS

    findings: List[StoreFinding] = []
    resolved, slot = _resolve(directory, slot, findings)
    if resolved is None:
        return StoreReport(directory, None, slot, findings)

    try:
        with open(os.path.join(resolved, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        findings.append(StoreFinding("manifest", f"unreadable manifest: {e}"))
        return StoreReport(directory, resolved, slot, findings)

    schema = manifest.get("schema")
    if schema not in KNOWN_SCHEMAS:
        findings.append(StoreFinding(
            "manifest",
            f"unknown store schema {schema!r} (this checker knows "
            f"{KNOWN_SCHEMAS}) — refusing to certify",
        ))
    artifacts = manifest.get("artifacts")
    if not isinstance(artifacts, dict) or not artifacts:
        findings.append(StoreFinding(
            "manifest", "manifest has no artifacts — nothing to serve from"
        ))
        return StoreReport(directory, resolved, slot, findings)

    for name, info in artifacts.items():
        missing_keys = [k for k in REQUIRED_INFO_KEYS if k not in info]
        if missing_keys:
            findings.append(StoreFinding(
                "manifest", f"missing manifest key(s) {missing_keys}", name
            ))
            continue

        # -- spec / configs decode ------------------------------------------
        spec = None
        try:
            spec = CrossbarSpec(**info["spec"])
        except TypeError as e:
            findings.append(StoreFinding("spec", f"undecodable CrossbarSpec: {e}", name))
        adc_cfg = None
        if info["adc_cfg"] is not None:
            try:
                adc_cfg = ADCConfig(**info["adc_cfg"])
            except TypeError as e:
                findings.append(StoreFinding("spec", f"undecodable ADCConfig: {e}", name))
        if info.get("device") is not None:
            try:
                DeviceConfig(**info["device"])
            except TypeError as e:
                findings.append(StoreFinding(
                    "spec", f"undecodable DeviceConfig: {e}", name
                ))
        t = info.get("t_service_s", 0.0)
        if not isinstance(t, (int, float)) or t < 0.0:
            findings.append(StoreFinding(
                "spec", f"invalid t_service_s {t!r} (service clock)", name
            ))
        for aux_key in ("report", "repair"):
            try:
                _decode_aux(info[aux_key])
            except (KeyError, TypeError, ValueError) as e:
                findings.append(StoreFinding(
                    "manifest", f"undecodable {aux_key} aux: {e}", name
                ))

        # -- array leaves via npz headers -----------------------------------
        npz_path = os.path.join(resolved, info["file"])
        headers = None
        if not os.path.isfile(npz_path):
            findings.append(StoreFinding(
                "arrays", f"missing array file {info['file']!r}", name
            ))
        else:
            try:
                headers = _npz_headers(npz_path)
            except (zipfile.BadZipFile, KeyError, ValueError, OSError) as e:
                findings.append(StoreFinding(
                    "arrays", f"unreadable npz {info['file']!r}: {e}", name
                ))
        if headers is not None:
            unknown = sorted(set(headers) - set(ARTIFACT_ARRAY_FIELDS))
            if unknown:
                findings.append(StoreFinding(
                    "arrays",
                    f"unknown array field(s) {unknown} — not ProgrammedLinear "
                    "leaves",
                    name,
                ))
            absent = [k for k in MANDATORY_ARRAYS if k not in headers]
            if absent:
                findings.append(StoreFinding(
                    "arrays", f"mandatory array field(s) {absent} missing", name
                ))
            if ("g_spare" in headers) != ("out_gather" in headers):
                findings.append(StoreFinding(
                    "arrays",
                    "g_spare/out_gather must travel as a pair (spare block "
                    "without its gather table is unservable)",
                    name,
                ))
            if spec is not None and "w_codes" in headers and "g_eff" in headers:
                wshape = headers["w_codes"][0]
                gshape = headers["g_eff"][0]
                if len(wshape) == 2:
                    want = (spec.n_slices,) + wshape
                    if gshape != want:
                        findings.append(StoreFinding(
                            "arrays",
                            f"g_eff shape {gshape} inconsistent with w_codes "
                            f"{wshape} under spec (expected {want}: one "
                            f"{spec.cell_bits}-bit slice plane per of "
                            f"{spec.n_slices})",
                            name,
                        ))

        # -- sharding specs --------------------------------------------------
        sharding = info.get("sharding")
        if sharding is not None:
            if not isinstance(sharding, dict):
                findings.append(StoreFinding(
                    "sharding", f"sharding must be a dict, got {type(sharding).__name__}", name
                ))
            else:
                bad_fields = sorted(set(sharding) - set(ARTIFACT_ARRAY_FIELDS))
                if bad_fields:
                    findings.append(StoreFinding(
                        "sharding", f"sharding names unknown field(s) {bad_fields}", name
                    ))
                for field, entries in sharding.items():
                    if not isinstance(entries, list) or not all(
                        e is None or isinstance(e, (str, list)) for e in entries
                    ):
                        findings.append(StoreFinding(
                            "sharding",
                            f"malformed PartitionSpec for {field}: {entries!r}",
                            name,
                        ))
                    elif headers is not None and field in headers:
                        rank = len(headers[field][0])
                        if len(entries) > rank:
                            findings.append(StoreFinding(
                                "sharding",
                                f"PartitionSpec for {field} has "
                                f"{len(entries)} entries but the array is "
                                f"rank {rank}",
                                name,
                            ))

        # -- plan admissibility ----------------------------------------------
        if info.get("plan") is not None:
            plan = None
            try:
                plan = _decode_plan(info["plan"])
            except (TypeError, ValueError) as e:
                findings.append(StoreFinding("plan", f"inadmissible plan: {e}", name))
            if plan is not None and spec is not None:
                if adc_cfg is not None:
                    try:
                        want_adc = adc_config_for(plan.adc_mode, spec)
                    except (KeyError, ValueError):
                        want_adc = None
                    if want_adc is not None and dataclasses.asdict(
                        want_adc
                    ) != dataclasses.asdict(adc_cfg):
                        findings.append(StoreFinding(
                            "plan",
                            f"recorded ADCConfig disagrees with plan's "
                            f"adc_mode={plan.adc_mode!r} under the recorded "
                            "spec — the chip is not the chip the plan admitted",
                            name,
                        ))
                if max_crossbar_factor is not None:
                    factor = datapath_crossbar_factor(plan.datapath, spec)
                    if factor > max_crossbar_factor:
                        findings.append(StoreFinding(
                            "plan",
                            f"plan over budget: datapath {plan.datapath!r} "
                            f"needs {factor:.2f}x crossbars > "
                            f"max_crossbar_factor={max_crossbar_factor}",
                            name,
                        ))
                if exactness is not None and headers is not None and "w_codes" in headers:
                    from repro_torch.core.planner import _admissible_adc_modes

                    rows = headers["w_codes"][0][0] if headers["w_codes"][0] else 0
                    admissible = _admissible_adc_modes(spec, rows, exactness)
                    if plan.adc_mode not in admissible:
                        findings.append(StoreFinding(
                            "plan",
                            f"adc_mode {plan.adc_mode!r} violates the "
                            f"{exactness!r} exactness contract "
                            f"(admissible: {sorted(admissible)})",
                            name,
                        ))

        # -- name-set / shape vs the model -----------------------------------
        if expected is not None and name in expected and headers is not None:
            want = tuple(expected[name])
            got = headers.get("w_codes", ((), ""))[0]
            if len(got) == len(want) and got != want:
                findings.append(StoreFinding(
                    "name-set",
                    f"w_codes shape {got} != model's expected {want}",
                    name,
                ))

    if expected is not None:
        store_names = set(artifacts)
        want_names = set(expected)
        for n in sorted(want_names - store_names):
            findings.append(StoreFinding(
                "name-set",
                "model expects an artifact the store lacks — restore would "
                "silently fall back to per-call reprogramming",
                n,
            ))
        for n in sorted(store_names - want_names):
            findings.append(StoreFinding(
                "name-set",
                "store carries an artifact the model never consumes "
                "(orphaned leaf — saved from a different model/config?)",
                n,
            ))

    return StoreReport(directory, resolved, slot, findings, n_artifacts=len(artifacts))
