"""One-call RL session builder (counterpart of ``repro/rl/session.py``):
task generator -> engine -> buffer -> orchestrator -> trainer -> eval from
a single declarative config.

    from repro_torch.rl.session import RLSession, SessionConfig
    out = RLSession.from_config(SessionConfig(task="logic",
                                              device="cpu")).run()

Ported so far: the single-engine loop on the paged
:class:`~repro_torch.rollout.engine.SlotEngine` (``engine="slot"``,
``num_replicas=1``), on the card unless ``SessionConfig.device`` names
another device.  Options that need a module of a later slice raise
``NotImplementedError``: ``engine="sim"`` (``rollout/sim.py``),
``num_replicas > 1`` and ``fault_plan`` (``rollout/group.py``),
``autoscaler`` (``rollout/autoscaler.py``) and ``arrival`` (the serving
tier, ``serve/``).

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
from repro_torch.rollout.engine import SlotEngine
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
    less the knobs of the modules not ported yet (EngineGroup routing and
    elasticity, the autoscaler's, the simulator's and the serving tier's),
    plus ``device``.  The options that select those modules stay and
    raise ``NotImplementedError``."""
    task: str = "logic"               # TASKS registry key
    policy: str = "sorted"            # scheduling-policy registry key
    policy_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    engine: str = "slot"              # slot (real decode); sim: later slice
    num_replicas: int = 1             # > 1: later slice (EngineGroup)
    fault_plan: Optional[List[Any]] = None      # later slice (EngineGroup)
    autoscaler: Optional[str] = None  # later slice
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
    arrival: Optional[Any] = None     # the serving tier: later slice
    # where the model, engine and trainer live: None is the card
    device: Optional[str] = None


def _check_ported(cfg: SessionConfig) -> None:
    if cfg.engine == "sim":
        raise NotImplementedError(
            "engine='sim' needs rollout/sim.py, a later slice of the port")
    if cfg.engine != "slot":
        raise ValueError(f"unknown engine {cfg.engine!r} "
                         "(expected 'slot' or 'sim')")
    n = cfg.num_replicas
    if n < 1 or cfg.rollout_batch % n != 0:
        raise ValueError(
            f"rollout_batch={cfg.rollout_batch} must split evenly "
            f"over num_replicas={n}")
    for on, what, module in (
            (n > 1, f"num_replicas={n}", "rollout/group.py (EngineGroup)"),
            (cfg.fault_plan, "fault_plan", "rollout/group.py (EngineGroup)"),
            (cfg.autoscaler, "autoscaler", "rollout/autoscaler.py"),
            (cfg.arrival is not None, "arrival", "the serving tier, serve/")):
        if on:
            raise NotImplementedError(
                f"{what} needs {module}, a later slice of the port")


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
                 evals: Optional[List[Dict]] = None):
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
        are the starting weights; they are trained in place."""
        if cfg.task not in TASKS:
            raise KeyError(f"unknown task {cfg.task!r}; "
                           f"registered: {sorted(TASKS)}")
        _check_ported(cfg)
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
                              overlap_updates=cfg.overlap_updates)
        evals: List[Dict] = []

        dev = resolve_device(cfg.device)
        model = build_model(tiny_lm_config(len(vocab), cfg.d_model,
                                           cfg.layers), device=dev)
        if params is None:
            params = model.init_params(
                torch.Generator(device=dev).manual_seed(cfg.seed))
        gen = spec.make_generator(cfg.seed)
        sft_examples = [gen.sft_example() for _ in range(2048)]
        params, sft_losses = sft_warmup(model, params, sft_examples,
                                        vocab.pad_id, steps=cfg.sft_steps,
                                        seed=cfg.seed, width=spec.sft_width)

        def reward_fn(toks, meta):
            return spec.verify(toks, meta, vocab)

        trainer = RLTrainer(model, params, reward_fn, loss_cfg=LossConfig(),
                            opt_cfg=AdamWConfig(lr=cfg.lr),
                            pad_id=vocab.pad_id, max_len=cfg.max_total_len,
                            advantage_kind=cfg.advantage_kind,
                            responses_per_prompt=cfg.responses_per_prompt)
        # partial mode keeps resident KV across weight syncs (recorded
        # logprobs stay exact as pi_old); on-policy re-rolls must
        # re-prefill under the fresh policy
        engine = SlotEngine(
            model, trainer.params, capacity=cfg.rollout_batch,
            max_total_len=cfg.max_total_len, max_gen_len=cfg.max_gen_len,
            eos_id=vocab.eos_id, pad_id=vocab.pad_id,
            temperature=cfg.temperature, seed=cfg.seed,
            kv_retain_across_sync=(Mode(cfg.mode) == Mode.PARTIAL),
            packed_prefill=cfg.packed_prefill,
            fused_sampling=cfg.fused_sampling, kv_quant=cfg.kv_quant)
        eval_set = spec.make_generator(9999).batch(cfg.eval_size)

        def train_fn(req: UpdateRequest) -> UpdateResult:
            result = trainer.handle(req)
            if trainer.state.step % cfg.eval_every == 0:
                ev = evaluate(model, trainer.params(), vocab, eval_set[0],
                              eval_set[1], reward_fn, cfg.max_gen_len,
                              cfg.max_total_len)
                ev["step"] = trainer.state.step
                evals.append(ev)
            return result

        front = make_trainer(cfg.trainer, fn=train_fn,
                             update_cost=cfg.update_cost,
                             update_cost_per_token=cfg.update_cost_per_token)
        orch = RolloutOrchestrator(engine, buffer, scfg, policy, front)
        session = cls(cfg, orch, GroupedLoader(
            gen, cfg.rollout_batch, cfg.group_size,
            cfg.responses_per_prompt), vocab, model=model, trainer=trainer,
            reward_fn=reward_fn, eval_set=eval_set, sft_losses=sft_losses,
            evals=evals)
        # barrier-free policies stream prompts instead of taking groups
        if (hasattr(policy, "prompt_stream")
                and policy.prompt_stream is None):
            policy.prompt_stream = session.loader.stream()
        return session

    # -- driving ------------------------------------------------------------

    def run(self) -> Dict:
        """Drive the configured number of groups to consumption and return
        the result record (history, evals, final eval, rollout metrics)."""
        cfg = self.cfg
        orch = self.orchestrator
        t0 = time.monotonic()
        if hasattr(self.policy, "queue_group"):         # pipelined lookahead
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
        return {
            "task": cfg.task,
            "strategy": cfg.policy,
            "mode": cfg.mode.value,
            "rollout_metrics": orch.metrics.summary(),
            "wall_time_s": wall,
            "sft_loss_final": (self.sft_losses[-1] if self.sft_losses
                               else None),
            "history": self.trainer.history,
            "evals": self.evals,
            "final_eval": evaluate(
                self.model, self.trainer.params(), self.vocab,
                self.eval_set[0], self.eval_set[1], self.reward_fn,
                cfg.max_gen_len, cfg.max_total_len),
        }
