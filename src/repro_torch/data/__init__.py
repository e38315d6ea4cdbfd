from repro_torch.data.pipeline import (Batch, PipelineConfig, SyntheticPipeline,
                                       pipeline_for_model)

__all__ = ["Batch", "PipelineConfig", "SyntheticPipeline", "pipeline_for_model"]
