"""Batched serving, split into a model runner and a slot scheduler
(counterpart of ``repro.serving.engine``).

``ModelRunner`` owns the model half: the params, the programmed crossbar chip
(program-once at construction, optionally under a ``core.planner.ChipPlan``
and a ``spare_cols`` repair budget, with one chip identity per expert of an
MoE model's banks under ``expert_chips``, or restored from an artifact store
that first passes ``analysis.verify_store``), the chip's lifecycle (``age`` /
``health_check`` / ``compensate`` / ``hot_swap`` / ``refresh``), prefill /
decode and sampling.  ``ServingEngine`` is the synchronous slot scheduler on
top: a fixed pool of ``max_batch`` cache slots; a pending request is
prefilled alone (an attention model's prompt zero-padded to a bucket, a
recurrent model's at its exact length) and its cache copied into a free slot;
one ``decode_step`` advances *all* slots each tick with per-slot positions;
finished slots are freed and refilled.  The traffic tier drives the same
runner: ``serving.scheduler.ContinuousBatchingScheduler`` (deadlines, a block
pool, exact preemption) and ``serving.farm.ChipFarm`` (replicas of this
engine behind one router).

The decode tick and the prefill are compiled as the reference jits them: on
the card the pool's ``decode_step`` is captured once as a CUDA graph and
replayed every tick (``serving.graphs.DecodeGraph``), and an attention
model's prefill is captured once per bucket and replayed at every admission
(``serving.graphs.PrefillGraph``); a recurrent model's prefill, at the
prompt's exact length, stays eager.  A captured graph reads the artifacts at
the addresses it was captured with, so every swap of the served chip
(``ModelRunner._rebind``) drops them all and the next tick or admission
captures afresh; KV caches, slots and pending requests are untouched, so
in-flight requests go on at the next tick.

An MoE model may be served as one rank's share of an expert-parallel
deployment (``share=``, a ``models.moe.ExpertShare``; its params hold that
share's experts): every forward of the runner runs under it.

Mesh serving (``mesh=``, a ``launch.mesh.Mesh`` inside a rank process of
``launch.mesh.run_ranks``; the counterpart of the reference's ``mesh=``):
every forward runs under ``use_mesh(mesh, layout_overrides(cfg))``, so each
MoE FFN runs the reference's body for ``cfg.layout`` (EP, all-to-all or
expert-TP) over the mesh's ranks.  The arguments say which form
``params`` takes: beside ``restore_artifacts=`` this rank's copy
(``moe.rank_params``), which the rank may load without the whole banks;
otherwise the whole tree, of which the runner keeps this rank's copy.
Programming under a mesh programs the whole chip from the whole tree and
keeps this rank's slices (``device.programmed.local_artifact``); a restore
or ``hot_swap`` reads only this rank's slices (``restore_programmed(mesh=)``),
laid out by ``cfg.layout``.  Params of the other form are refused.  Every
leaf outside the MoE FFNs — attention, dense FFNs, shared experts, the head
— and its artifact stays whole on every rank, and every rank computes them
whole, as the reference's ``ep_only`` layout replicates them: the port has
no head-parallel attention.  Under a
mesh nothing is captured: gloo's collectives are host calls, so the ticks
and prefills run eagerly (``decode_graph`` stays None and
``prefill_graphs`` empty).  Every rank samples alike (argmax at temperature
<= 0, a generator seeded alike above it), so the ranks generate the same
tokens; the engine adds no collective for that.  A chip's lifecycle past
``age`` and ``hot_swap`` (``health_check``, ``compensate``, ``refresh``) and
``save_artifacts`` are refused under a mesh.

An embedding front end (musicgen-large, pixtral-12b: precomputed frame or
patch embeddings in place of tokens) programs, checks and saves its chip
like any model; ``ServingEngine.submit`` refuses its requests, since a slot
holds token ids (the reference's engine fails on them in its admission).
Such a chip serves through ``models.model.prefill`` / ``decode_step`` under
the runner's crossbar mode.

Generation is deterministic given (seed, admission order).  The decode tick
returns host float32 logits — one device synchronisation per tick.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import types
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.analysis.store import verify_store
from repro_torch.checkpoint import active_slot, restore_programmed, save_programmed, swap_active
from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner import ChipPlan
from repro_torch.device import health as health_mod
from repro_torch.device import programmed as prog_mod
from repro_torch.device.models import wants_repair
from repro_torch.models import layers as layers_mod
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import CrossbarMode, crossbar_mode
from repro_torch.serving.graphs import DecodeGraph, PrefillBuffers, PrefillGraph
from repro_torch.tree import flatten


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32 tokens
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # allow truncating a prompt longer than max_seq to its first max_seq
    # tokens; without it an over-length prompt is refused at submit()
    truncate: bool = False
    # traffic tier (serving.scheduler): absolute tick by which the request
    # must finish, else it is evicted with expired=True; None = no deadline
    deadline: Optional[int] = None
    # streaming: called as on_token(req, tok) for every generated token,
    # including the prefill-sampled first token of recurrent archs
    on_token: Optional[Callable[["Request", int], None]] = None
    arrival: int = 0  # scheduler tick at submit time
    finish: Optional[int] = None  # scheduler tick after the finishing step
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    expired: bool = False


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


class ModelRunner:
    """The model half of serving: chip + prefill/decode + sampling.  Knows
    nothing about which requests run when."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_seq: int = 512,
        temperature: float = 0.0,
        seed: int = 0,
        crossbar: Optional[CrossbarMode] = None,
        spare_cols: Optional[int] = None,
        restore_artifacts: Optional[str] = None,
        verify_coverage: bool = True,
        expert_chips=None,
        plan: Optional[ChipPlan] = None,
        share: Optional[moe_mod.ExpertShare] = None,
        mesh=None,
        device="cuda",
    ):
        self.device = model_lib.require_device(device)
        self.cfg = cfg
        self.mesh = mesh
        whole = params
        if mesh is not None:
            if share is not None:
                raise ValueError(
                    f"an ExpertShare ({share}) and a mesh do not combine: the mesh's ranks hold the experts"
                )
            _require_bank_form(params, cfg, mesh, rank_copy=restore_artifacts is not None)
            if restore_artifacts is None:
                params = moe_mod.rank_params(params, cfg, mesh)
        self.params = params
        self.max_seq = max_seq
        self.temperature = temperature
        self._sample_gen = torch.Generator(device="cpu")
        self._sample_gen.manual_seed(seed)
        # the expert-parallel share the params hold (None: the whole model)
        self.share = share
        # one chip identity per expert of every 4-D expert bank
        # (program_model(expert_chips=)); remembered so that refresh()
        # reprograms the same fleet
        self.expert_chips = tuple(expert_chips) if expert_chips is not None else None
        # the chip-plan compiler's per-layer datapath / ADC choices, threaded
        # into program_model at deploy time
        self.plan = plan
        self.crossbar = self._program_crossbars(crossbar, spare_cols, restore_artifacts, whole)
        if verify_coverage:
            self.verify_crossbar_coverage()
        self._decode_graph: Optional[DecodeGraph] = None
        # one captured prefill per bucket (attention models), as the
        # reference keeps one jitted prefill per bucket, on static inputs
        # they share (made at the first admission)
        self._prefill_graphs: Dict[int, PrefillGraph] = {}
        self._prefill_buffers: Optional[PrefillBuffers] = None

    # ------------------------------------------------------------------
    @property
    def _tie_lm_head(self) -> bool:
        return self.cfg.tie_embeddings and self.cfg.frontend == "token"

    def _program_crossbars(
        self,
        crossbar: Optional[CrossbarMode],
        spare_cols: Optional[int] = None,
        restore_artifacts: Optional[str] = None,
        whole_params=None,
    ):
        """Program-once compilation of the model's weights (deploy time,
        under ``self.plan`` when one is given), or restore of a previously
        saved chip: the store is verified from its manifests first, then
        loaded bit-for-bit, and no ``program_layer`` call runs.
        ``whole_params``: the tree a mesh runner programs from.

        ``spare_cols`` overrides the device's spare-column budget at deploy
        time (``device.repair`` then remaps the worst stuck-cell columns of
        every projection before serving).  0 disables a budget; a positive
        budget that cannot take effect (no device, no stuck cells, prebuilt
        or restored artifacts) is refused rather than ignored."""
        if restore_artifacts is not None:
            if crossbar is None or not crossbar.enabled:
                raise ValueError(
                    "restore_artifacts= needs crossbar serving enabled "
                    "(pass crossbar=CrossbarMode(enabled=True, ...))"
                )
            if crossbar.programmed is not None:
                raise ValueError(
                    "restore_artifacts= with prebuilt CrossbarMode.programmed "
                    "artifacts: pick one source of truth"
                )
            if spare_cols is not None:
                raise ValueError(
                    "spare_cols= cannot rebudget a restored chip (not even "
                    "to 0): the repair plan was baked in when the artifacts "
                    "were programmed — reprogram with the desired budget"
                )
            if self.plan is not None:
                raise ValueError(
                    "plan= cannot replan a restored chip: the datapath / ADC "
                    "/ spare choices were baked in when the artifacts were "
                    "programmed — reprogram with the desired plan"
                )
            expected = self._verify_store(restore_artifacts, None, "restore_artifacts=")
            prog = self._restore(restore_artifacts, None)
            # a stale or mismatched store would resolve no artifacts and
            # degrade every projection to per-call reprogramming: cross-check
            # the store against what this model would program
            bad = sorted(
                name for name, shape in expected.items()
                if prog.lookup(name, shape) is None
            )
            if bad:
                raise ValueError(
                    f"restored artifact store at {restore_artifacts!r} does not "
                    f"match this model: {len(bad)}/{len(expected)} projections "
                    f"missing or shape-mismatched ({', '.join(bad[:5])}"
                    + (", ..." if len(bad) > 5 else "")
                    + ") — was it saved from a different model/config?"
                )
            return dataclasses.replace(crossbar, programmed=prog)
        if crossbar is None or not crossbar.enabled or crossbar.programmed is not None:
            if spare_cols:
                raise ValueError(
                    "spare_cols= needs crossbar serving with a DeviceConfig "
                    "to repair and no prebuilt artifacts (set spare_cols on "
                    "the DeviceConfig passed to program_model instead)"
                )
            return crossbar
        if spare_cols is not None:
            if crossbar.device is None:
                if spare_cols:
                    raise ValueError(
                        "spare_cols= without a CrossbarMode.device: there is "
                        "no fault model to repair against"
                    )
            else:
                device_cfg = crossbar.device.replace(spare_cols=spare_cols)
                if spare_cols > 0 and not wants_repair(device_cfg):
                    raise ValueError(
                        f"spare_cols={spare_cols} on a device with no "
                        "stuck-at faults (p_stuck_on == p_stuck_off == 0): "
                        "nothing to repair"
                    )
                crossbar = dataclasses.replace(crossbar, device=device_cfg)
        return dataclasses.replace(crossbar, programmed=self._program(crossbar, whole_params))

    def _program(self, crossbar: CrossbarMode, whole_params=None):
        """Program the runner's params under ``crossbar``'s device config and
        the runner's plan (deploy time and ``refresh``).  Under a mesh the
        whole chip is programmed from ``whole_params`` and this rank's
        slices are kept."""
        prog = prog_mod.program_model(
            self.params if self.mesh is None else whole_params,
            device_cfg=crossbar.device,
            fast=crossbar.fast,
            tie_lm_head=self._tie_lm_head,
            expert_chips=self.expert_chips,
            plan=self.plan,
            device=self.device,
        )
        if self.mesh is None:
            return prog
        specs = self._mesh_specs()

        def local(node, path):
            if isinstance(node, dict):
                return {k: local(v, path + (k,)) for k, v in node.items()}
            spec = specs.get("/".join(path))
            return node if spec is None else prog_mod.local_artifact(node, spec, self.mesh.shape, self.mesh.coords)

        return prog_mod.ProgrammedModel(local(prog.artifacts, ()))

    def _mesh_specs(self) -> Dict[str, tuple]:
        """{name: spec} of the leaves the mesh slices (every MoE FFN's router
        and banks, under ``cfg.layout``)."""
        return moe_mod.param_specs(self.params, self.cfg, self.mesh)

    def _restore(self, directory: str, slot: Optional[str]):
        """The store's chip on this runner's device: under a mesh, this
        rank's slices laid out by ``cfg.layout``."""
        if self.mesh is None:
            return restore_programmed(directory, device=self.device, slot=slot)
        return restore_programmed(directory, device=self.device, slot=slot, mesh=self.mesh, specs=self._mesh_specs())

    def _require_one_device(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} under a mesh is not ported yet (ROADMAP, open items: the chip lifecycle under a mesh)"
            )

    def _verify_store(self, directory: str, slot: Optional[str], what: str) -> Dict[str, tuple]:
        """Fail-fast static verification of a store before any array loads:
        a corrupt slot pointer, an undecodable spec or plan, inconsistent
        leaf shapes or a wrong name set is refused with the failing rule
        named.  Orphaned leaves (a store that is a superset of the model)
        are left to ``verify_crossbar_coverage``.  Returns the expected
        name -> shape map for the binding cross-check (under a mesh, this
        rank's shapes; the store is checked against the whole model's)."""
        expected = prog_mod.expected_artifact_names(self.params, tie_lm_head=self._tie_lm_head)
        whole = expected
        if self.mesh is not None:
            # a rank's copy is taken as the spec's even split of the whole
            sizes = self.mesh.shape
            whole = dict(expected)
            for name, spec in self._mesh_specs().items():
                if name in whole:
                    whole[name] = tuple(
                        d if e is None else d * prog_mod._axes_size(e, sizes) for d, e in zip(whole[name], spec)
                    )
        report = verify_store(directory, expected=whole, slot=slot)
        fatal = [
            f for f in report.findings
            if not (f.rule == "name-set" and "orphaned leaf" in f.message)
        ]
        if fatal:
            report.findings[:] = fatal
            raise ValueError(
                f"{what} store failed static verification "
                "(repro_torch.analysis.verify_store): it is internally "
                "inconsistent or does not match this model —\n" + report.summary()
            )
        return expected

    def verify_crossbar_coverage(self) -> None:
        """Structural name-set check at construction: one real 4-token
        forward under the runner's crossbar mode must consume exactly the
        programmed model's emitted name set — a renamed layer or an artifact
        no call site serves fails construction, before the first request.
        An embedding front end's forward takes (1, 4, D) zero embeddings in
        the params' dtype.  The ambient miss and consumption records are put
        back afterwards."""
        if self.crossbar is None or self.crossbar.programmed is None:
            return
        if self.cfg.frontend == "token":
            inp = torch.zeros((1, 4), dtype=torch.long, device=self.device)
        else:
            dtype = self.params["final_norm"].dtype
            inp = torch.zeros((1, 4, self.cfg.d_model), dtype=dtype, device=self.device)
        before_consumed = prog_mod.consumed_artifact_names()
        before_misses = layers_mod.crossbar_miss_counts()
        prog_mod.reset_consumed_artifact_names()
        try:
            self._with_crossbar(lambda: model_lib.forward(self.params, self.cfg, inp))
            self.crossbar.programmed.verify_consumed()
        finally:
            prog_mod.reset_consumed_artifact_names()
            for n in before_consumed:
                prog_mod.record_artifact_consumed(n)
            layers_mod.restore_crossbar_misses(before_misses)

    def save_artifacts(self, directory: str, slot: Optional[str] = None) -> str:
        """Persist the programmed chip so a restart can restore instead of
        reprogram (``ServingEngine(..., restore_artifacts=directory)``)."""
        if self.crossbar is None or self.crossbar.programmed is None:
            raise ValueError(
                "no programmed artifacts to save: construct the engine with "
                "crossbar=CrossbarMode(enabled=True, ...) first"
            )
        self._require_one_device("save_artifacts() (a rank holds its slices only)")
        return save_programmed(directory, self.crossbar.programmed, slot=slot)

    @property
    def programmed(self):
        """The bound ``ProgrammedModel`` (None when not crossbar-serving)."""
        return self.crossbar.programmed if self.crossbar is not None else None

    def repair_reports(self):
        """Path -> ``RepairReport`` (a per-layer tuple for a stacked leaf) of
        every repaired projection ({} when repair is off)."""
        prog = self.programmed
        return prog.repair_reports() if prog is not None else {}

    # ------------------------------------------------------------------
    # Chip lifecycle: monitor -> compensate -> refresh
    # ------------------------------------------------------------------

    @property
    def uptime_s(self) -> float:
        """Service time of the bound chips, seconds since programming."""
        prog = self.programmed
        return prog.t_service_s if prog is not None else 0.0

    def _require_programmed(self, what: str):
        prog = self.programmed
        if prog is None:
            raise ValueError(
                f"{what} needs programmed crossbar serving: construct the "
                "engine with crossbar=CrossbarMode(enabled=True, ...)"
            )
        return prog

    def _rebind(self, prog) -> None:
        """Swap the served chip and drop the captured decode tick and
        prefills.

        A graph reads the artifacts at the addresses it was captured with
        (and ``compensate`` turns ``comp_scale`` from None into a tensor,
        which changes the program itself), so it is dropped, never patched
        in place: the next tick and the next admission of each bucket
        capture afresh against the new chip.  KV caches, slots and pending
        requests belong to the scheduler and are untouched — in-flight
        requests go on at the next tick."""
        self._decode_graph = None
        self._prefill_graphs.clear()
        self.crossbar = dataclasses.replace(self.crossbar, programmed=prog)

    def age(self, dt_s: float) -> None:
        """Advance every bound chip ``dt_s`` seconds of service (the
        device's retention drift, no reprogramming; a drift-free chip only
        advances its clock)."""
        prog = self._require_programmed("age()")
        self._rebind(prog.age(dt_s))

    def health_check(self, n_probes: Optional[int] = None, seed: int = 0, budget: Optional[float] = None):
        """Probe every bound artifact against its digital twin; returns a
        ``device.health.HealthReport`` (``flagged``: the layers over
        budget).  Does not touch the chips."""
        prog = self._require_programmed("health_check()")
        self._require_one_device("health_check()")
        kw = {}
        if n_probes is not None:
            kw["n_probes"] = n_probes
        if budget is not None:
            kw["budget"] = budget
        return health_mod.health_check(prog, seed=seed, **kw)

    def compensate(self, n_probes: Optional[int] = None, seed: int = 0) -> None:
        """Refit the digital drift compensation (``comp_scale``) of every
        noisy chip and rebind: no reprogramming."""
        prog = self._require_programmed("compensate()")
        self._require_one_device("compensate()")
        kw = {"n_probes": n_probes} if n_probes is not None else {}
        self._rebind(health_mod.compensate_model(prog, seed=seed, **kw))

    def hot_swap(self, directory: str, slot: Optional[str] = None) -> None:
        """Rebind the chip from an artifact store between ticks: the store is
        verified first (``analysis.verify_store``, as a restore is), restored
        (the ``ACTIVE`` slot unless ``slot`` is forced) and cross-checked
        against this model's projections; a corrupt or mismatched store is
        refused and the old chip keeps serving.  Under a mesh the rank reads
        its slices."""
        self._require_programmed("hot_swap()")
        expected = self._verify_store(directory, slot, "hot_swap")
        prog = self._restore(directory, slot)
        bad = sorted(name for name, shape in expected.items() if prog.lookup(name, shape) is None)
        if bad:
            raise ValueError(
                f"hot_swap store at {directory!r} does not match this model: "
                f"{len(bad)}/{len(expected)} projections missing or "
                f"shape-mismatched ({', '.join(bad[:5])}"
                + (", ..." if len(bad) > 5 else "") + ")"
            )
        self._rebind(prog)

    def refresh(self, directory: Optional[str] = None) -> Optional[str]:
        """Reprogram fresh chips and swap them in: the params under the
        runner's device config and plan (deterministic: the chip the engine
        started with, at service time zero).  With ``directory`` the fresh
        chip is written to the *inactive* store slot, the ``ACTIVE``
        pointer is swapped and the runner hot-swaps from the store; returns
        the committed slot.  Without one the chip is rebound directly."""
        self._require_programmed("refresh()")
        self._require_one_device("refresh()")
        prog = self._program(self.crossbar)
        if directory is None:
            self._rebind(prog)
            return None
        target = "B" if active_slot(directory) == "A" else "A"
        save_programmed(directory, prog, slot=target)
        del prog  # the store's copy is what gets bound
        swap_active(directory, target)
        self.hot_swap(directory)
        return target

    def _with_crossbar(self, fn):
        """Run ``fn`` under the runner's mesh and crossbar mode with the
        programmed model's name-keyed artifact table bound, and as the
        runner's expert share."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(moe_mod.expert_share(self.share))
            if self.mesh is not None:
                stack.enter_context(layers_mod.use_mesh(self.mesh, layers_mod.layout_overrides(self.cfg)))
            if self.crossbar is not None:
                stack.enter_context(crossbar_mode(self.crossbar))
                if self.crossbar.programmed is not None:
                    stack.enter_context(self.crossbar.programmed.bind())
            return fn()

    # ------------------------------------------------------------------
    # Scheduler-facing surface: cache init, prefill-admit, decode, sample
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, dtype=torch.float32):
        """A dense slot-pool cache sized to this runner's ``max_seq``."""
        return model_lib.init_cache(self.cfg, batch, self.max_seq, dtype=dtype, device=self.device)

    def check_prompt(self, prompt, truncate: bool) -> int:
        """Validate a prompt against ``max_seq``; returns the effective
        (possibly truncated) prefill length."""
        S = len(prompt)
        if S > self.max_seq:
            if not truncate:
                raise ValueError(
                    f"prompt of length {S} exceeds max_seq={self.max_seq}: "
                    "it cannot be prefilled into the slot pool — raise "
                    "max_seq, shorten the prompt, or pass truncate=True to "
                    "serve the first max_seq tokens"
                )
            return self.max_seq
        return S

    def prefill_len(self, S: int) -> int:
        """Length of the prefill that admits a prompt of ``S`` tokens (after
        ``check_prompt``).  Recurrent state (ssm / hybrid families) would
        absorb padding tokens, so those prefill the exact length; attention
        caches tolerate padding (masked by position): a zero-padded bucket,
        then an idempotent re-issue of token S-1."""
        if self.cfg.family in ("ssm", "hybrid"):
            return S
        return min(_bucket(S), self.max_seq)

    def admit_slot(self, cache, slot: int, req: Request):
        """Prefill one request and copy its cache into slot ``slot`` (in
        place).  Returns ``(cache, pos, last_tok, first_tok)``; attention
        models re-issue the last prompt token on the first decode tick, so
        ``first_tok`` is None; recurrent models sample the first token from
        the prefill logits.

        An attention model's prompt is prefilled by its bucket's
        ``PrefillGraph`` (captured at the bucket's first admission, on the
        card); a recurrent model's runs eagerly at its exact length, and
        under a mesh every prefill runs eagerly, each on a fresh one-slot
        cache."""
        S = self.check_prompt(req.prompt, req.truncate)
        recurrent = self.cfg.family in ("ssm", "hybrid")
        length = self.prefill_len(S)
        prompt = np.zeros((1, length), np.int64)
        prompt[0, :S] = np.asarray(req.prompt)[:S]
        if recurrent or self.mesh is not None:
            # one graph per distinct prompt length would be one capture and
            # one pool each: recurrent prefills stay eager; a mesh's
            # collectives are host calls, which a graph cannot hold
            small_cache = self.init_cache(1)
            tokens = torch.from_numpy(prompt).to(self.device)
            logits, filled = self._with_crossbar(
                lambda: model_lib.prefill(self.params, self.cfg, tokens, small_cache)
            )
        else:
            graph = self._prefill_graphs.get(length)
            if graph is None:
                if self._prefill_buffers is None:
                    self._prefill_buffers = PrefillBuffers(self)
                graph = self._prefill_graphs[length] = PrefillGraph(self, length, self._prefill_buffers)
            logits, filled = graph.run(prompt)
        for big_stage, one_stage in zip(cache, filled):
            for b, entry in one_stage.items():
                for n, one in entry.items():
                    big_stage[b][n][:, slot] = one[:, 0]
        if recurrent:
            tok = int(self.sample(logits.to(torch.float32).cpu().numpy())[0])
            return cache, S, tok, tok
        return cache, S - 1, int(np.asarray(req.prompt)[S - 1]), None

    def decode(self, last_tok: np.ndarray, pos: np.ndarray, cache):
        """One decode tick over the whole slot pool; returns
        ``(logits, cache)`` with logits as host float32.  The tick is the
        runner's ``DecodeGraph`` for this cache: captured on the first call
        (a CUDA graph on the card) and replayed after; a call with another
        cache drops the graph and builds one for it.  Under a mesh each tick
        runs eagerly."""
        if self.mesh is not None:
            inp = torch.from_numpy(np.stack([last_tok, pos]).astype(np.int64)).to(self.device)
            logits, _ = self._with_crossbar(
                lambda: model_lib.decode_step(self.params, self.cfg, inp[0].unsqueeze(1), inp[1], cache)
            )
            return logits.to(torch.float32).cpu().numpy(), cache
        graph = self._decode_graph
        if graph is None or not graph.serves(cache):
            self._decode_graph = None  # free the old graph's memory first
            graph = self._decode_graph = DecodeGraph(self, cache)
        return graph.run(last_tok, pos), cache

    @property
    def decode_graph(self) -> Optional[DecodeGraph]:
        """The captured tick of the last cache decoded (None before the
        first tick); a runner keeps at most one."""
        return self._decode_graph

    @property
    def prefill_graphs(self) -> Mapping[int, PrefillGraph]:
        """The captured prefills by bucket (read-only; empty for a recurrent
        model and after every chip swap); a runner keeps at most one per
        bucket up to ``max_seq``."""
        return types.MappingProxyType(self._prefill_graphs)

    def sample(self, logits: np.ndarray) -> np.ndarray:
        if self.temperature <= 0.0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        u = torch.rand(logits.shape, generator=self._sample_gen, dtype=torch.float64)
        g = -torch.log(-torch.log(u.clamp_min(1e-300))).numpy()
        return np.argmax(logits / self.temperature + g, axis=-1).astype(np.int32)


def _require_bank_form(params, cfg: ModelConfig, mesh, rank_copy: bool) -> None:
    """Refuse ``params`` whose expert banks are not in the form a mesh
    runner's arguments call for: the whole tree when it programs or serves
    digitally (the runner takes this rank's copy of it), this rank's copy
    (``moe.rank_params``) beside ``restore_artifacts=``."""
    flat = flatten(params)
    for name, spec in moe_mod.param_specs(params, cfg, mesh).items():
        if name.endswith("/wi"):
            split = 1 if spec[-3] is None else prog_mod._axes_size(spec[-3], mesh.shape)
            want = cfg.moe_experts // split if rank_copy else cfg.moe_experts
            if flat[name].shape[-3] != want:
                raise ValueError(
                    f"{name} holds {flat[name].shape[-3]} experts, not {want}: under a mesh, "
                    + ("restore_artifacts= takes this rank's copy of params (moe.rank_params)" if rank_copy
                       else "programming or digital serving takes the whole params tree")
                )


class ServingEngine:
    """Slot scheduler over a ``ModelRunner``: a fixed slot pool and a FIFO
    pending queue; ``step()`` admits and advances, ``run_until_done()``
    drains."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_batch: int = 4,
        max_seq: int = 512,
        temperature: float = 0.0,
        seed: int = 0,
        crossbar: Optional[CrossbarMode] = None,
        spare_cols: Optional[int] = None,
        restore_artifacts: Optional[str] = None,
        verify_coverage: bool = True,
        expert_chips=None,
        plan: Optional[ChipPlan] = None,
        rid_start: int = 0,
        share: Optional[moe_mod.ExpertShare] = None,
        mesh=None,
        device="cuda",
    ):
        self.runner = ModelRunner(
            cfg,
            params,
            max_seq=max_seq,
            temperature=temperature,
            seed=seed,
            crossbar=crossbar,
            spare_cols=spare_cols,
            restore_artifacts=restore_artifacts,
            verify_coverage=verify_coverage,
            expert_chips=expert_chips,
            plan=plan,
            share=share,
            mesh=mesh,
            device=device,
        )
        self.max_batch = max_batch
        self.cache = self.runner.init_cache(max_batch)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)  # position of next write
        self.last_tok = np.zeros(max_batch, np.int32)
        self.pending: List[Request] = []
        # completion ledger: step() records every finished request the moment
        # it frees the slot, so a request admitted and finished within one
        # step() (max_new_tokens=1) cannot vanish from run_until_done()
        self._completed: Dict[int, Request] = {}
        # rid_start: disjoint rid ranges per replica when a ChipFarm fans one
        # request stream across several engines (serving.farm)
        self._rid = itertools.count(rid_start)

    # -- delegation: the model half lives on the runner -----------------
    @property
    def cfg(self) -> ModelConfig:
        return self.runner.cfg

    @property
    def params(self):
        return self.runner.params

    @property
    def max_seq(self) -> int:
        return self.runner.max_seq

    @property
    def temperature(self) -> float:
        return self.runner.temperature

    @property
    def plan(self) -> Optional[ChipPlan]:
        return self.runner.plan

    @property
    def expert_chips(self):
        return self.runner.expert_chips

    @property
    def share(self) -> Optional[moe_mod.ExpertShare]:
        return self.runner.share

    @property
    def mesh(self):
        return self.runner.mesh

    @property
    def crossbar(self) -> Optional[CrossbarMode]:
        return self.runner.crossbar

    @property
    def programmed(self):
        return self.runner.programmed

    def verify_crossbar_coverage(self) -> None:
        self.runner.verify_crossbar_coverage()

    def save_artifacts(self, directory: str, slot: Optional[str] = None) -> str:
        return self.runner.save_artifacts(directory, slot=slot)

    # -- the chip lifecycle (see ModelRunner) ---------------------------
    @property
    def uptime_s(self) -> float:
        return self.runner.uptime_s

    def repair_reports(self):
        return self.runner.repair_reports()

    def age(self, dt_s: float) -> None:
        self.runner.age(dt_s)

    def health_check(self, n_probes: Optional[int] = None, seed: int = 0, budget: Optional[float] = None):
        return self.runner.health_check(n_probes=n_probes, seed=seed, budget=budget)

    def compensate(self, n_probes: Optional[int] = None, seed: int = 0) -> None:
        self.runner.compensate(n_probes=n_probes, seed=seed)

    def hot_swap(self, directory: str, slot: Optional[str] = None) -> None:
        self.runner.hot_swap(directory, slot=slot)

    def refresh(self, directory: Optional[str] = None) -> Optional[str]:
        return self.runner.refresh(directory)

    # ------------------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        truncate: bool = False,
        on_token: Optional[Callable[[Request, int], None]] = None,
    ) -> int:
        if self.cfg.frontend != "token":
            # the reference's engine fails on such a request inside its
            # admission (a token buffer); refused here, before it is queued
            raise ValueError(
                f"{self.cfg.name}: front end {self.cfg.frontend!r} (precomputed frame / patch embeddings): the serving "
                "engine takes token prompts; serve it through models.model.prefill / decode_step"
            )
        prompt = np.asarray(prompt)
        # refuse over-length prompts at submit time unless truncation was
        # explicitly allowed
        self.runner.check_prompt(prompt, truncate)
        req = Request(
            next(self._rid), prompt, max_new_tokens, eos_id,
            truncate=truncate, on_token=on_token,
        )
        self.pending.append(req)
        return req.rid

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            self.cache, p, lt, first = self.runner.admit_slot(self.cache, slot, req)
            self.pos[slot] = p
            self.last_tok[slot] = lt
            if first is not None:
                req.generated.append(first)
                if req.on_token is not None:
                    req.on_token(req, first)
            self.slots[slot] = req

    def step(self) -> int:
        """Admit pending requests and advance every occupied slot one token.
        Finished requests are recorded in the completion ledger as their
        slots free.  Returns the number of active slots advanced."""
        self._admit()
        active = [i for i in range(self.max_batch) if self.slots[i] is not None]
        if not active:
            return 0
        logits, self.cache = self.runner.decode(self.last_tok, self.pos, self.cache)
        nxt = self.runner.sample(logits)
        for i in active:
            req = self.slots[i]
            self.pos[i] += 1
            tok = int(nxt[i])
            req.generated.append(tok)
            self.last_tok[i] = tok
            if req.on_token is not None:
                req.on_token(req, tok)
            if (
                len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or self.pos[i] >= self.max_seq - 1
            ):
                req.done = True
                self._completed[req.rid] = req
                self.slots[i] = None
        return len(active)

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.pending and all(s is None for s in self.slots):
                break
            self.step()
        out = dict(self._completed)
        for s in self.slots:
            if s is not None:
                out[s.rid] = s
        return sorted(out.values(), key=lambda r: r.rid)
