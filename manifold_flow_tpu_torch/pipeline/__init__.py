"""Pipeline: typed configuration (pipeline.config), the stages S0-S7
(pipeline.stages, with S0's BIDS parsing in pipeline.preprocess), batch
runs over a results tree (pipeline.batch) and the command line
(pipeline.cli), whose rendering options draw through viz. Counterpart of
manifold_flow_tpu.pipeline. The velocity, singularity, wave-speed and
winding stages, run_trial and run_batch take a `device_mesh` (parallel),
run_batch and the batch CLI `distributed` ranks as well."""

from manifold_flow_tpu_torch.pipeline import batch, config, preprocess, stages

__all__ = ["batch", "config", "preprocess", "stages"]
