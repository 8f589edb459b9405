"""One-call RL session builder (counterpart of ``repro/rl/session.py``):
task generator -> engine -> buffer -> orchestrator -> trainer -> eval from
a single declarative config.

    from repro_torch.rl.session import RLSession, SessionConfig
    out = RLSession.from_config(SessionConfig(task="logic",
                                              device="cpu")).run()

Every field of the reference's ``SessionConfig`` is taken, plus
``device``: the rollout engine is the paged
:class:`~repro_torch.rollout.engine.SlotEngine` (``engine="slot"``, on
the card unless ``device`` names another) or the discrete-event
:class:`~repro_torch.rollout.sim.SimEngine` (``engine="sim"``,
scheduling only: no model, trainer or eval); ``num_replicas > 1``,
``fault_plan`` and ``autoscaler`` put an
:class:`~repro_torch.rollout.group.EngineGroup` of equal shards behind
the orchestrator (every slot replica shares the trainer's weights and
holds its own page pool), and ``arrival`` switches to the always-on
serving tier (:mod:`repro_torch.serve`).

Starting weights: ``from_config(cfg, params=...)`` takes them, else they
are drawn from ``cfg.seed`` with a ``torch.Generator`` (the reference
draws from ``jax.random``, which torch cannot reproduce; parity tests
pass the reference's weights through ``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import tiny_lm_config  # noqa: F401 (re-export)
from repro_torch.core.buffer import BufferEntry, Mode, StatefulRolloutBuffer
from repro_torch.core.engine_api import FaultInjector
from repro_torch.core.orchestrator import (RolloutOrchestrator,
                                           SortedRLConfig, UpdateRequest,
                                           UpdateResult)
from repro_torch.core.policy import make_policy
from repro_torch.data import logic, math_synth
from repro_torch.data.loader import GroupedLoader, TaskGenerator
from repro_torch.data.tokenizer import Vocab
from repro_torch.models.model import Model, build_model
from repro_torch.rl.losses import LossConfig
from repro_torch.rl.trainer import RLTrainer, make_trainer, value_and_grad
from repro_torch.rollout.autoscaler import Autoscaler
from repro_torch.rollout.engine import SlotEngine
from repro_torch.rollout.group import EngineGroup
from repro_torch.rollout.sim import SimEngine
from repro_torch.serve import (Ingress, ServingOrchestrator, ServingPolicy,
                               coerce_specs, make_arrivals)
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


# ---------------------------------------------------------------------------
# SFT warm-up (plays the role of starting from an instruct checkpoint)
# ---------------------------------------------------------------------------

def sft_warmup(model: Model, params, examples: Sequence[Tuple[List[int],
                                                              List[int]]],
               pad_id: int, steps: int = 200, batch_size: int = 32,
               lr: float = 1e-3, seed: int = 0, width: int = 96):
    """Next-token loss on the targets of ``examples``; the batches are the
    reference's draw (``np.random.RandomState(seed)``).  ``params`` are
    updated in place and returned with the losses."""
    opt_cfg = AdamWConfig(lr=lr, grad_clip=1.0)
    opt_state = init_opt_state(params, opt_cfg)
    rng = np.random.RandomState(seed)

    def loss_fn(p, tokens, mask):
        logits, _ = model.forward(p, {"tokens": tokens})
        lp = torch.log_softmax(logits.float(), dim=-1)
        tgt = tokens[:, 1:].long()
        lp_t = torch.gather(lp[:, :-1], 2, tgt[:, :, None])[..., 0]
        m = mask[:, 1:]
        return -(lp_t * m).sum() / torch.clamp(m.sum(), min=1.0), None

    losses = []
    for _ in range(steps):
        idx = rng.randint(0, len(examples), batch_size)
        toks = np.full((batch_size, width), pad_id, np.int32)
        mask = np.zeros((batch_size, width), np.float32)
        for i, j in enumerate(idx):
            prompt, target = examples[j]
            seq = (prompt + target)[:width]
            toks[i, :len(seq)] = seq
            mask[i, len(prompt):len(seq)] = 1.0
        (loss, _), grads = value_and_grad(
            loss_fn, params, torch.from_numpy(toks).to(model.device),
            torch.from_numpy(mask).to(model.device))
        params, opt_state, _ = adamw_update(params, grads, opt_state,
                                            opt_cfg)
        losses.append(float(loss))
    return params, losses


# ---------------------------------------------------------------------------
# Evaluation: greedy decode through the engine
# ---------------------------------------------------------------------------

def evaluate(model: Model, params, vocab: Vocab, prompts, metas,
             reward_fn, max_gen: int = 24, max_total: int = 128) -> Dict:
    eng = SlotEngine(model, lambda: params, capacity=len(prompts),
                     max_total_len=max_total, max_gen_len=max_gen,
                     eos_id=vocab.eos_id, pad_id=vocab.pad_id,
                     temperature=0.0)
    entries = [BufferEntry(uid=i, prompt=list(p), meta=m)
               for i, (p, m) in enumerate(zip(prompts, metas))]
    eng.submit(entries, version=0)
    gen: Dict[int, List[int]] = {e.uid: [] for e in entries}
    while eng.active_uids():
        for ev in eng.step():
            gen[ev.uid].append(ev.token)
    rewards = [reward_fn(gen[e.uid], e.meta) for e in entries]
    return {
        "reward_mean": float(np.mean(rewards)),
        "solve_rate": float(np.mean([r >= 1.2 for r in rewards])),
        "gen_len_mean": float(np.mean([len(g) for g in gen.values()])),
    }


# ---------------------------------------------------------------------------
# task registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """A verifiable task: vocab + generator factory + rule-based verifier."""
    vocab: Vocab
    make_generator: Callable[[int], TaskGenerator]
    verify: Callable[[Sequence[int], Any, Vocab], float]
    sft_width: int        # warm-up padding width (task-shaped)


TASKS: Dict[str, TaskSpec] = {
    "logic": TaskSpec(logic.VOCAB,
                      lambda seed: logic.LogicTaskGenerator(seed=seed),
                      logic.verify, sft_width=96),
    "math": TaskSpec(math_synth.MATH_VOCAB,
                     lambda seed: math_synth.MathTaskGenerator(seed=seed),
                     math_synth.verify, sft_width=64),
}


# ---------------------------------------------------------------------------
# session config + builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SessionConfig:
    """Declarative description of a full RL run: the reference's fields,
    field for field, plus ``device``."""
    task: str = "logic"               # TASKS registry key
    policy: str = "sorted"            # scheduling-policy registry key
    policy_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    engine: str = "slot"              # slot (real decode) | sim (scheduling)
    # data-parallel rollout: shard rollout_batch slots over this many
    # engine replicas behind an EngineGroup (1 = plain single engine)
    num_replicas: int = 1
    balancer: str = "least_tokens"    # EngineGroup routing (group.py registry)
    async_step: bool = False          # per-replica dispatch, no step barrier
    drain_pack: bool = False          # tail packing via KV migration
    # chaos / elasticity: a deterministic fault plan the EngineGroup
    # applies per group step -- FaultEvent instances or plain tuples
    # (step, replica, kind[, duration[, factor]]); requires
    # num_replicas > 1 (faults are injected per replica)
    fault_plan: Optional[List[Any]] = None
    elastic: bool = False             # enable scale_up / scale_down
    # feedback-driven autoscaling (repro_torch.rollout.autoscaler): an
    # AutoscalerPolicy name ("bubble_target" | "queue_depth") builds an
    # elastic EngineGroup plus an Autoscaler that scales it from windowed
    # metrics each group step; scale_up mints replicas through the same
    # per-replica builder (rollout_batch // num_replicas slots each);
    # max_replicas=None caps the fleet at its starting size
    autoscaler: Optional[str] = None
    autoscaler_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=dict)         # policy knobs (high/low marks, ...)
    autoscaler_window: float = 1.0    # metrics window span, seconds
    min_replicas: int = 1             # never shed below this
    max_replicas: Optional[int] = None  # never grow above this
    # packed segment-masked prefill, in-kernel greedy sampling, int8 KV
    # pages (None | "int8")
    packed_prefill: bool = False
    fused_sampling: bool = False
    kv_quant: Optional[str] = None
    mode: Mode = Mode.ON_POLICY
    rollout_batch: int = 32           # engine capacity (slots)
    group_size: int = 2
    update_batch: int = 32
    max_gen_len: int = 24
    max_total_len: int = 160
    n_groups: int = 4
    sft_steps: int = 150
    lr: float = 3e-4
    temperature: float = 1.0
    seed: int = 0
    d_model: int = 128
    layers: int = 4
    eval_every: int = 4               # updates between evals
    eval_size: int = 64
    # paper LogicRL setting: k responses per prompt (duplicated entries
    # sharing prompt_id -> grpo groups or reinforce++ batch stats)
    responses_per_prompt: int = 1
    advantage_kind: str = "reinforce_pp"   # reinforce_pp | grpo
    harvest_threshold: Optional[int] = None
    train_leftover: bool = True
    # trainer hand-off: "sync" (serialized) or "streaming" (rollout/update
    # overlap; set overlap_updates too); update_cost models the trainer's
    # per-batch seconds on the rollout clock
    trainer: str = "sync"
    overlap_updates: bool = False
    update_cost: float = 0.0
    update_cost_per_token: float = 0.0
    sim_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # always-on serving tier (repro_torch.serve): setting `arrival`
    # switches to continuous batching under a ServingOrchestrator -- the
    # policy is wrapped by the "serving" policy and prompts stream in
    # through per-tenant admission-controlled queues
    tenants: Optional[List[Any]] = None    # TenantSpec | dict per tenant
    arrival: Optional[Any] = None          # {"kind": "poisson"|"bursty",
                                           #  "rates": {...}, ...} |
                                           # {"kind": "trace", "trace": [...]}
                                           # | a prebuilt arrival process
    admission: str = "fifo"                # fifo|weighted_fair|slo_aware
    serve_time: Optional[float] = None     # run_for sim-time bound
    serve_arrivals: Optional[int] = None   # run_for arrival-count bound
    serve_tick: Optional[float] = None     # serving-clock dt per step for
                                           # wall-clock engines (slot)
    # where the model, engine and trainer live: None is the card
    device: Optional[str] = None


class RLSession:
    """A fully-wired RL run; build with :meth:`from_config`, drive with
    :meth:`run` (or step the parts manually via the public attributes)."""

    def __init__(self, cfg: SessionConfig, orchestrator: RolloutOrchestrator,
                 loader: GroupedLoader, vocab: Vocab,
                 model: Optional[Model] = None,
                 trainer: Optional[RLTrainer] = None,
                 reward_fn: Optional[Callable] = None,
                 eval_set: Optional[Tuple[List, List]] = None,
                 sft_losses: Optional[List[float]] = None,
                 evals: Optional[List[Dict]] = None,
                 sched_history: Optional[List[Dict]] = None):
        self.cfg = cfg
        self.orchestrator = orchestrator
        self.loader = loader
        self.vocab = vocab
        self.model = model
        self.trainer = trainer
        self.reward_fn = reward_fn
        self.eval_set = eval_set
        self.sft_losses = sft_losses or []
        self.evals = evals if evals is not None else []
        self.sched_history = sched_history if sched_history is not None else []

    # convenience pass-throughs
    @property
    def engine(self):
        return self.orchestrator.engine

    @property
    def buffer(self):
        return self.orchestrator.buffer

    @property
    def policy(self):
        return self.orchestrator.policy

    @property
    def metrics(self):
        return self.orchestrator.metrics

    @classmethod
    def from_config(cls, cfg: SessionConfig, params=None) -> "RLSession":
        """Wire the run.  ``params`` (the tiny LM's tree, on ``cfg.device``)
        are the starting weights of a slot session; they are trained in
        place.  A sim session builds no model and touches no device."""
        if cfg.task not in TASKS:
            raise KeyError(f"unknown task {cfg.task!r}; "
                           f"registered: {sorted(TASKS)}")
        spec = TASKS[cfg.task]
        vocab = spec.vocab
        policy = make_policy(cfg.policy, **cfg.policy_kwargs)
        buffer = StatefulRolloutBuffer(cfg.mode)
        scfg = SortedRLConfig(mode=cfg.mode, rollout_batch=cfg.rollout_batch,
                              group_size=cfg.group_size,
                              update_batch=cfg.update_batch,
                              max_gen_len=cfg.max_gen_len,
                              harvest_threshold=cfg.harvest_threshold,
                              train_leftover=cfg.train_leftover,
                              num_replicas=cfg.num_replicas,
                              async_step=cfg.async_step,
                              drain_pack=cfg.drain_pack,
                              overlap_updates=cfg.overlap_updates)
        evals: List[Dict] = []
        sched_history: List[Dict] = []

        # the per-replica builder is kept for the autoscaler's replica
        # factory: scale_up mints replicas through the closure that built
        # the starting fleet (same shard size, seed offset by the index)
        replica_builder: List[Any] = [None]

        def replicated(build_one):
            """`rollout_batch` slots as one engine or an EngineGroup of
            `num_replicas` equal shards (each with its own KV memory)."""
            replica_builder[0] = build_one
            n = cfg.num_replicas
            if n < 1 or cfg.rollout_batch % n != 0:
                raise ValueError(
                    f"rollout_batch={cfg.rollout_batch} must split evenly "
                    f"over num_replicas={n}")
            if n == 1 and cfg.fault_plan:
                raise ValueError(
                    "fault_plan requires num_replicas > 1 (faults are "
                    "injected per replica of an EngineGroup)")
            if n == 1 and not cfg.autoscaler:
                return build_one(0, cfg.rollout_batch)
            injector = (FaultInjector(cfg.fault_plan)
                        if cfg.fault_plan else None)
            return EngineGroup([build_one(i, cfg.rollout_batch // n)
                                for i in range(n)], balancer=cfg.balancer,
                               async_step=cfg.async_step,
                               drain_pack=cfg.drain_pack or None,
                               fault_injector=injector,
                               elastic=cfg.elastic or bool(cfg.autoscaler),
                               spread_tenants=cfg.arrival is not None)

        def build_autoscaler():
            if not cfg.autoscaler:
                return None
            build_one = replica_builder[0]
            shard = cfg.rollout_batch // max(1, cfg.num_replicas)
            return Autoscaler(
                cfg.autoscaler,
                factory=lambda idx: build_one(idx, shard),
                min_replicas=cfg.min_replicas,
                max_replicas=(cfg.max_replicas if cfg.max_replicas
                              is not None else cfg.num_replicas),
                window=cfg.autoscaler_window,
                policy_kwargs=cfg.autoscaler_kwargs)

        def make_orchestrator(engine, train_fn) -> RolloutOrchestrator:
            """Epoch-driven orchestrator, or -- when `arrival` is set --
            the serving tier: the configured policy wrapped by the
            admission-controlled ServingPolicy over a streaming ingress,
            driven by a ServingOrchestrator."""
            front = make_trainer(
                cfg.trainer, fn=train_fn, update_cost=cfg.update_cost,
                update_cost_per_token=cfg.update_cost_per_token)
            if cfg.arrival is None:
                return RolloutOrchestrator(engine, buffer, scfg, policy,
                                           front,
                                           autoscaler=build_autoscaler())
            specs = coerce_specs(cfg.tenants if cfg.tenants
                                 else [{"name": "default"}])
            arrival = cfg.arrival
            if isinstance(arrival, dict):
                arrival = dict(arrival)
                if arrival.get("kind", "poisson") != "trace":
                    arrival.setdefault("seed", cfg.seed)
                    arrival.setdefault("rates",
                                       {s.name: 1.0 for s in specs})
                    if "prompt_sampler" not in arrival:
                        # serving prompts come from the task generator,
                        # payload = the verifier meta (reward_fn unwraps
                        # it from ServeMeta.payload)
                        serve_gen = spec.make_generator(cfg.seed + 101)

                        def task_sampler(rng, tenant):
                            p, m = serve_gen.batch(1)
                            return list(p[0]), m[0]
                        arrival["prompt_sampler"] = task_sampler
                arrival = make_arrivals(arrival)
            ingress = Ingress(specs, arrival)
            serving_policy = ServingPolicy(inner=policy,
                                           admission=cfg.admission,
                                           ingress=ingress)
            tick = cfg.serve_tick
            if tick is None and cfg.engine == "slot":
                # wall-clock engine: a fixed per-step tick keeps every
                # scheduling decision on the simulated clock
                tick = 0.05
            return ServingOrchestrator(engine, buffer, scfg,
                                       serving_policy, front,
                                       ingress=ingress, tick=tick,
                                       autoscaler=build_autoscaler())

        if cfg.engine == "slot":
            dev = resolve_device(cfg.device)
            model = build_model(tiny_lm_config(len(vocab), cfg.d_model,
                                               cfg.layers), device=dev)
            if params is None:
                params = model.init_params(
                    torch.Generator(device=dev).manual_seed(cfg.seed))
            gen = spec.make_generator(cfg.seed)
            sft_examples = [gen.sft_example() for _ in range(2048)]
            params, sft_losses = sft_warmup(model, params, sft_examples,
                                            vocab.pad_id,
                                            steps=cfg.sft_steps,
                                            seed=cfg.seed,
                                            width=spec.sft_width)

            def reward_fn(toks, meta):
                # serving requests carry their task meta in
                # ServeMeta.payload; everything else passes through
                meta = getattr(meta, "payload", meta)
                return spec.verify(toks, meta, vocab)
            trainer = RLTrainer(model, params, reward_fn,
                                loss_cfg=LossConfig(),
                                opt_cfg=AdamWConfig(lr=cfg.lr),
                                pad_id=vocab.pad_id,
                                max_len=cfg.max_total_len,
                                advantage_kind=cfg.advantage_kind,
                                responses_per_prompt=cfg.responses_per_prompt)
            # partial mode keeps resident KV across weight syncs (recorded
            # logprobs stay exact as pi_old); on-policy re-rolls must
            # re-prefill under the fresh policy.  Every replica reads the
            # trainer's one weight tree.
            engine = replicated(lambda i, cap: SlotEngine(
                model, trainer.params, capacity=cap,
                max_total_len=cfg.max_total_len,
                max_gen_len=cfg.max_gen_len,
                eos_id=vocab.eos_id, pad_id=vocab.pad_id,
                temperature=cfg.temperature, seed=cfg.seed + i,
                kv_retain_across_sync=(Mode(cfg.mode) == Mode.PARTIAL),
                packed_prefill=cfg.packed_prefill,
                fused_sampling=cfg.fused_sampling,
                kv_quant=cfg.kv_quant))
            eval_set = spec.make_generator(9999).batch(cfg.eval_size)

            def train_fn(req: UpdateRequest) -> UpdateResult:
                result = trainer.handle(req)
                if trainer.state.step % cfg.eval_every == 0:
                    ev = evaluate(model, trainer.params(), vocab,
                                  eval_set[0], eval_set[1], reward_fn,
                                  cfg.max_gen_len, cfg.max_total_len)
                    ev["step"] = trainer.state.step
                    evals.append(ev)
                return result

            orch = make_orchestrator(engine, train_fn)
            session = cls(cfg, orch, GroupedLoader(
                gen, cfg.rollout_batch, cfg.group_size,
                cfg.responses_per_prompt), vocab, model=model,
                trainer=trainer, reward_fn=reward_fn, eval_set=eval_set,
                sft_losses=sft_losses, evals=evals)
        elif cfg.engine == "sim":
            # scheduling-only: discrete-event engine, batch-stats trainer
            gen = spec.make_generator(cfg.seed)
            # modeled residency survives weight syncs only in partial
            # mode, as on the slot path (explicit sim_kwargs still win)
            sim_kwargs = dict(cfg.sim_kwargs)
            sim_kwargs.setdefault("kv_retain_across_sync",
                                  Mode(cfg.mode) == Mode.PARTIAL)
            engine = replicated(lambda i, cap: SimEngine(
                capacity=cap, max_gen_len=cfg.max_gen_len, seed=cfg.seed + i,
                **sim_kwargs))

            def train_fn(req: UpdateRequest) -> UpdateResult:
                lens = [e.gen_len for e in req.entries]
                rec = {"entries": len(req.entries),
                       "gen_len_mean": sum(lens) / len(lens),
                       "staleness_mean": req.staleness_mean,
                       "version": req.version}
                sched_history.append(rec)
                return UpdateResult(metrics=rec)

            orch = make_orchestrator(engine, train_fn)
            session = cls(cfg, orch, GroupedLoader(
                gen, cfg.rollout_batch, cfg.group_size,
                cfg.responses_per_prompt), vocab,
                sched_history=sched_history)
        else:
            raise ValueError(f"unknown engine {cfg.engine!r} "
                             "(expected 'slot' or 'sim')")

        # barrier-free policies stream prompts instead of taking groups
        # (under the serving tier prompts come from the ingress instead)
        if (cfg.arrival is None and hasattr(policy, "prompt_stream")
                and policy.prompt_stream is None):
            policy.prompt_stream = session.loader.stream()
        return session

    # -- driving ------------------------------------------------------------

    def run(self) -> Dict:
        """Drive the configured number of groups to consumption (or, with
        ``arrival``, serve until the arrival or time bound) and return the
        result record (history, evals, final eval, rollout metrics)."""
        cfg = self.cfg
        orch = self.orchestrator
        t0 = time.monotonic()
        if cfg.arrival is not None:                     # always-on serving
            n_arr = cfg.serve_arrivals
            if n_arr is None and cfg.serve_time is None:
                # default bound: the epoch path's total prompt budget
                n_arr = cfg.n_groups * self.loader.prompts_per_group
            orch.run_for(sim_time=cfg.serve_time, n_arrivals=n_arr)
        elif hasattr(self.policy, "queue_group"):       # pipelined lookahead
            for _ in range(cfg.n_groups):
                prompts, metas = self.loader.next_group()
                self.policy.queue_group(prompts, metas)
            orch.run_queued()
        elif hasattr(self.policy, "prompt_stream"):     # ungrouped streaming
            total = cfg.n_groups * self.loader.prompts_per_group
            orch.run_steps(n_updates=max(1, total // cfg.update_batch))
        else:                                           # strict grouped
            for _ in range(cfg.n_groups):
                prompts, metas = self.loader.next_group()
                orch.run_group(prompts, metas)
        wall = round(time.monotonic() - t0, 1)

        out = {
            "task": cfg.task,
            "strategy": cfg.policy,
            "mode": cfg.mode.value,
            "rollout_metrics": orch.metrics.summary(),
            "wall_time_s": wall,
        }
        if cfg.arrival is not None:
            out["admission"] = cfg.admission
        if self.trainer is not None:
            out["sft_loss_final"] = (self.sft_losses[-1]
                                     if self.sft_losses else None)
            out["history"] = self.trainer.history
            out["evals"] = self.evals
            out["final_eval"] = evaluate(
                self.model, self.trainer.params(), self.vocab,
                self.eval_set[0], self.eval_set[1], self.reward_fn,
                cfg.max_gen_len, cfg.max_total_len)
        else:
            out["history"] = self.sched_history
        return out
