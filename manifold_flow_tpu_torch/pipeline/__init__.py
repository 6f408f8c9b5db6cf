"""Pipeline: typed configuration (pipeline.config), the S3 velocity and
singularity stages (pipeline.stages) and the `flow` command line
(pipeline.cli). Counterpart of manifold_flow_tpu.pipeline; the other stages,
`pipeline/batch.py` and the other subcommands are ROADMAP Queue A item 14."""

from manifold_flow_tpu_torch.pipeline import config, stages

__all__ = ["config", "stages"]
