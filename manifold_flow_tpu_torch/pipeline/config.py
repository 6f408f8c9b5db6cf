"""One typed configuration tree for the whole pipeline.

A copy of manifold_flow_tpu/pipeline/config.py, which imports no JAX: the
port reads and writes the same configuration files.

Subsumes the reference's three uncoordinated mechanisms (SURVEY.md §5.6):
config.yaml blocks (general + per-subject paths), positional argv
(subject/run/trial), and hard-coded module constants (filter bands, time
windows, frame ranges). `PipelineConfig.from_yaml` also reads the
reference's own config.yaml layout (config.yaml:1-41) for interop.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class SolverConfig:
    lambda_: float = 0.01          # config.yaml:3
    eps: float = 1e-4              # config.yaml:4
    time_steps: int = 98           # config.yaml:5
    method: str = "auto"           # 'auto' | 'cg' | 'cholesky' | 'refined'
    tol: float = 1e-8
    # Inner f32 PCG tolerance(s) of the refined method: a scalar applies to
    # every outer step; a tuple is a per-outer-step schedule (last entry
    # repeats). Default = solve.refine.DEFAULT_INNER_TOL, the measured-best
    # tight-first schedule — the first step's inner accuracy sets the
    # delivered error while later corrections shrink ~1e-2/step, so loosening
    # them is free speed (solve/refine.py). YAML expresses a schedule as a
    # list: `inner_tol: [1e-3, 1e-2]`. The literal here must equal the
    # port's solve.refine.DEFAULT_INNER_TOL (config imports no torch); a
    # test pins the two together (tests/test_torch_pipeline.py).
    inner_tol: "float | tuple" = (1e-3, 1e-2)
    max_iter: int = 2000
    # Frames that fail `tol` at max_iter are re-solved with the refined
    # (f32 inner PCG, f64 residual) method before warning; set False
    # to only warn. Silent non-convergence would quietly corrupt every
    # downstream artifact (singularities, streamlines, winding lines).
    escalate: bool = True
    # the reference's processes_num (config.yaml:6) maps to device counts:
    n_frame_shards: Optional[int] = None
    n_mesh_shards: int = 1


@dataclasses.dataclass
class PreprocessConfig:
    """S0 constants (S0_preprocess.py:17-19, 107-117)."""
    low_freq: float = 0.1
    high_freq: float = 100.0
    baseline: tuple = (-1.0, -0.1)
    tmin: float = -2.0
    tmax: float = 3.0
    power_line_default: float = 50.0


@dataclasses.dataclass
class InterpolationConfig:
    """S2 constants (S2_interpolate.py:18-20) + RBF settings."""
    start_time: float = 2.009
    end_time: float = 2.2
    kind: str = "multiquadric"
    smooth: float = 0.0


@dataclasses.dataclass
class ReconstructionConfig:
    """S1 constants (S1_reconstruct_surface.py:91-95)."""
    smooth_iters: int = 100
    subdivisions: int = 3
    group: str = "grid"


@dataclasses.dataclass
class AnalysisConfig:
    threshold: float = 10.0        # config.yaml:15 (validation matching)
    max_winding_level: int = 25    # S7:120
    min_streamline_length: int = 20  # S6:17
    max_streamline_steps: int = 256
    n_modes: int = 4               # S4 nmodeplot
    turning_point: int = 67        # find_singularity_point.py:705 (comment)


@dataclasses.dataclass
class SubjectConfig:
    """Per-subject path block (config.yaml:21-41)."""
    name: str = ""
    surface_path: str = ""
    potentials_path: str = ""
    e_path: str = ""
    v_k_path: str = ""
    processed_surface_path: str = ""
    singularity_points_path: str = ""
    singularity_points_classification_path: str = ""
    velocity_fields_gif_path: str = ""
    epochs_save_path: str = ""
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PipelineConfig:
    # Opt-in bit-parity with three reference quirks that are fixed by
    # default (each is a documented accident in the original code):
    #   * phases stage runs Hilbert over scipy's default axis=-1, the
    #     ELECTRODE axis (S2_interpolate_phases.py:66) instead of time;
    #   * streamline single-shared-cell test feeds vertex INDICES to the
    #     coordinate geometry (S6_streamline.py:115-117);
    #   * interior-Jacobian nearest-edge picks by flat component argmin
    #     (utils/find_singularity_point.py:318-351).
    # With True, S2-phases / S3-classification / S6 artifacts match the
    # reference's outputs exactly.
    reference_quirks: bool = False
    # Shape-bucket surfaces in the JAX package's `pipeline/batch.py`. The
    # port has no mesh padding (stages.load_surface(pad=True) raises); the
    # field is kept so both packages read the same configuration files.
    pad_meshes: bool = True
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    preprocess: PreprocessConfig = dataclasses.field(
        default_factory=PreprocessConfig)
    interpolation: InterpolationConfig = dataclasses.field(
        default_factory=InterpolationConfig)
    reconstruction: ReconstructionConfig = dataclasses.field(
        default_factory=ReconstructionConfig)
    analysis: AnalysisConfig = dataclasses.field(default_factory=AnalysisConfig)
    subjects: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path) -> "PipelineConfig":
        """Read a config file, accepting the reference's config.yaml layout."""
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            raw = yaml.safe_load(f) or {}

        def num(v):
            # YAML 1.1 parses exponent literals without a dot ('1e-4') as
            # strings; the reference's config.yaml uses that form. Lists
            # (inner_tol schedules) normalize elementwise to a tuple.
            if isinstance(v, (list, tuple)):
                return tuple(num(x) for x in v)
            if isinstance(v, str):
                try:
                    return float(v)
                except ValueError:
                    return v
            return v

        cfg = cls()
        gen = raw.pop("general", {}) or {}
        for key, attr in [("lambda_", "lambda_"), ("eps", "eps"),
                          ("time_steps", "time_steps"), ("method", "method"),
                          ("tol", "tol"), ("inner_tol", "inner_tol"),
                          ("max_iter", "max_iter")]:
            if key in gen:
                val = gen[key]
                setattr(cfg.solver, attr,
                        num(val) if key != "method" else val)
        if "processes_num" in gen:
            # Reference pool size; informational only.
            cfg.solver.n_frame_shards = None
        if "reference_quirks" in gen:
            cfg.reference_quirks = bool(gen["reference_quirks"])
        if "pad_meshes" in gen:
            cfg.pad_meshes = bool(gen["pad_meshes"])
        for section, obj in [("preprocess", cfg.preprocess),
                             ("interpolation", cfg.interpolation),
                             ("reconstruction", cfg.reconstruction),
                             ("analysis", cfg.analysis)]:
            blk = raw.pop(section, {}) or {}
            for k, v in blk.items():
                if hasattr(obj, k):
                    setattr(obj, k, v)
        # Remaining top-level blocks are subjects (incl. 'simulated_data').
        for name, blk in raw.items():
            if not isinstance(blk, dict):
                continue
            subj = SubjectConfig(name=name)
            for k, v in blk.items():
                if hasattr(subj, k) and k != "extra":
                    setattr(subj, k, v)
                else:
                    subj.extra[k] = v
            if "threshold" in subj.extra:
                cfg.analysis.threshold = subj.extra["threshold"]
            cfg.subjects[name] = subj
        return cfg

    def to_yaml(self, path=None) -> str:
        import yaml

        def clean(x):
            if dataclasses.is_dataclass(x):
                return {k: clean(v) for k, v in dataclasses.asdict(x).items()}
            if isinstance(x, dict):
                return {k: clean(v) for k, v in x.items()}
            if isinstance(x, tuple):
                return list(x)
            return x

        doc = {
            "general": {**clean(self.solver),
                        "reference_quirks": self.reference_quirks,
                        "pad_meshes": self.pad_meshes},
            "preprocess": clean(self.preprocess),
            "interpolation": clean(self.interpolation),
            "reconstruction": clean(self.reconstruction),
            "analysis": clean(self.analysis),
        }
        for name, subj in self.subjects.items():
            doc[name] = {k: v for k, v in clean(subj).items()
                         if v not in ("", {}, None) and k != "name"}
        text = yaml.safe_dump(doc, sort_keys=False)
        if path is not None:
            Path(path).write_text(text)
        return text
