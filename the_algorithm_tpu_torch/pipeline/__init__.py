"""Pipeline framework: the product-mixer analog (typed, in-process).

Counterpart of ``the_algorithm_tpu/pipeline/``: the component model, the
recommendation engine, the mixer and the URT marshaller, all host code.
"""

from the_algorithm_tpu_torch.pipeline.component import (  # noqa: F401
    Candidate,
    CandidatePipeline,
    CandidateSource,
    FeatureHydrator,
    Filter,
    FilterResult,
    Gate,
    QueryFeatureHydrator,
    Scorer,
    Selector,
    SideEffect,
)
from the_algorithm_tpu_torch.pipeline.mixer import (  # noqa: F401
    EntryKind,
    Instruction,
    MixerCandidatePipeline,
    MixerPipeline,
    Module,
    Timeline,
    TimelineEntry,
)
from the_algorithm_tpu_torch.pipeline.recommendation import (  # noqa: F401
    FailOpenPolicy,
    PipelineResult,
    QualityFactorConfig,
    RecommendationPipeline,
)
