"""Staged UUA enrichment driver: repartition + hydration with failure
semantics.

Counterpart of ``the_algorithm_tpu/actions/enricher.py``, copied.

≡ ``unified_user_actions/enricher/`` — the reference drives each event
through an *enrichment plan* of stages
(``driver/EnrichmentDriver.scala``): a REPARTITION stage remaps the
Kafka key via the partitioner and emits to the partitioned topic; a
HYDRATION stage folds its instructions through the hydrator (which may
return the envelope un-hydrated to tolerate a recoverable failure, while
an unhandled error aborts the stage), then the driver continues locally
until the next repartition or the terminal state, where the envelope
lands on the final output topic.

Host-side plumbing (Kafka analog: per-topic queues), so plain Python —
the enriched stream's consumers (live_updates, aggregation, USS) are the
TPU side.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from the_algorithm_tpu_torch.actions.uua import UnifiedUserAction


class StageType(enum.Enum):
    REPARTITION = "repartition"
    HYDRATION = "hydration"


@dataclasses.dataclass(frozen=True)
class Stage:
    """≡ EnrichmentStage thrift: type + instruction list."""

    stage_type: StageType
    instructions: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    """≡ EnrichmentPlan: ordered stages + completion cursor."""

    stages: Tuple[Stage, ...]
    completed: int = 0

    @property
    def is_complete(self) -> bool:
        return self.completed >= len(self.stages)

    @property
    def current(self) -> Stage:
        return self.stages[self.completed]

    def advance(self) -> "Plan":
        return dataclasses.replace(self, completed=self.completed + 1)


@dataclasses.dataclass(frozen=True)
class EnrichmentKey:
    """≡ EnrichmentKey thrift: the partitioned-topic key."""

    key_type: str
    value: int


@dataclasses.dataclass
class Envelope:
    """≡ EnrichmentEnvelop: the event riding the staged pipeline."""

    action: UnifiedUserAction
    plan: Plan
    output_topic: Optional[str] = None


class HydrationError(Exception):
    """Unrecoverable hydration failure: aborts the event's stage (the
    event lands on the dead-letter side, never the final topic)."""


class Hydrator:
    """``hydrate(instruction, key, envelope) -> envelope``.

    Failure contract (≡ the reference's comment in EnrichmentDriver):
    return the envelope UN-hydrated to tolerate a recoverable error;
    raise :class:`HydrationError` to abort the event.
    """

    def hydrate(self, instruction: str, key: Optional[EnrichmentKey],
                envelope: Envelope) -> Envelope:
        raise NotImplementedError


class Partitioner:
    """``repartition(instruction, envelope) -> EnrichmentKey | None``
    (≡ ``partitioner/Partitioner.scala``)."""

    def repartition(self, instruction: str,
                    envelope: Envelope) -> Optional[EnrichmentKey]:
        raise NotImplementedError


class DefaultPartitioner(Partitioner):
    """≡ DefaultPartitioner: key by the tweet id (or author id) so each
    partition's hydrator gets key-local batches."""

    def repartition(self, instruction, envelope):
        a = envelope.action
        if instruction == "REPARTITION_TWEET_ID":
            return (EnrichmentKey("tweet", int(a.item_id))
                    if a.item_id is not None else None)
        if instruction == "REPARTITION_AUTHOR_ID":
            return (EnrichmentKey("author", int(a.author_id))
                    if a.author_id is not None else None)
        raise ValueError(f"unknown repartition instruction {instruction}")


class EnrichmentDriver:
    """≡ ``driver/EnrichmentDriver.scala``: executes one (key, envelope)
    step, returning (key, envelope, destination_topic).

    - plan complete → final topic (requires one to be configured);
    - repartition stage (exactly one instruction) → remap key, emit to
      the partitioned topic;
    - hydration stage → fold the instructions through the hydrator, then
      recurse locally (until a repartition or the terminal state).
    """

    def __init__(self, final_topic: Optional[str], partitioned_topic: str,
                 hydrator: Hydrator, partitioner: Partitioner):
        self.final_topic = final_topic
        self.partitioned_topic = partitioned_topic
        self.hydrator = hydrator
        self.partitioner = partitioner

    def execute(
        self, key: Optional[EnrichmentKey], envelope: Envelope
    ) -> Tuple[Optional[EnrichmentKey], Envelope, str]:
        plan = envelope.plan
        if plan.is_complete:
            if self.final_topic is None:
                raise RuntimeError(
                    "plan complete but no final output topic configured")
            envelope.output_topic = self.final_topic
            return key, envelope, self.final_topic
        stage = plan.current
        if stage.stage_type is StageType.REPARTITION:
            if len(stage.instructions) != 1:
                raise ValueError(
                    "re-partitioning needs exactly 1 instruction but "
                    f"{len(stage.instructions)} were provided")
            new_key = self.partitioner.repartition(
                stage.instructions[0], envelope)
            envelope.plan = plan.advance()
            envelope.output_topic = self.partitioned_topic
            return new_key, envelope, self.partitioned_topic
        if stage.stage_type is StageType.HYDRATION:
            if not stage.instructions:
                raise ValueError("hydration needs at least one instruction")
            for instruction in stage.instructions:
                envelope = self.hydrator.hydrate(instruction, key, envelope)
            envelope.plan = envelope.plan.advance()
            # continue locally until a repartition or the terminal state
            return self.execute(key, envelope)
        raise ValueError(f"unsupported stage type {stage.stage_type}")


@dataclasses.dataclass
class StagedRunResult:
    final: List[Envelope]
    dead_letters: List[Tuple[Envelope, str]]
    partitioned_batches: int


def run_staged(
    actions: Sequence[UnifiedUserAction],
    plan: Plan,
    hydrator: Hydrator,
    *,
    partitioner: Optional[Partitioner] = None,
    final_topic: str = "uua-enriched",
    partitioned_topic: str = "uua-partitioned",
) -> StagedRunResult:
    """The Kafka loop analog: drive every action through the staged plan,
    re-consuming the partitioned topic (key-grouped, the repartition
    locality) until everything reaches the final topic or dead-letters.
    """
    driver = EnrichmentDriver(final_topic, partitioned_topic, hydrator,
                              partitioner or DefaultPartitioner())
    pending: List[Tuple[Optional[EnrichmentKey], Envelope]] = [
        (None, Envelope(a, plan)) for a in actions
    ]
    final: List[Envelope] = []
    dead: List[Tuple[Envelope, str]] = []
    batches = 0
    while pending:
        repartitioned: Dict[Any, List[Tuple[Optional[EnrichmentKey],
                                            Envelope]]] = {}
        for key, env in pending:
            try:
                out_key, out_env, topic = driver.execute(key, env)
            except HydrationError as e:
                dead.append((env, str(e)))
                continue
            if topic == final_topic:
                final.append(out_env)
            else:
                part = (out_key.key_type, out_key.value) if out_key else None
                repartitioned.setdefault(part, []).append((out_key, out_env))
        pending = []
        for part_key in sorted(repartitioned, key=str):
            pending.extend(repartitioned[part_key])
            batches += 1
    return StagedRunResult(final, dead, batches)
