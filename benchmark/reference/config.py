"""Typed configuration of the PyTorch port — the port's own copy of
``piecewise_icp_tpu/config.py`` (the port imports nothing of that package).

The reference drives everything from an 11-line positional text config
(parser: CommonFunc.cpp:11-136, schema: CommonFunc.h:48-61) plus a set of
compiled-in constants scattered through the C++ sources.  Here every knob
lives in one typed, validated dataclass; the reference text format is still
parsed for drop-in compatibility.  The fields that only the JAX package
reads (backend and kernel selection, static-shape padding) are left out;
:func:`config_from_jax` turns a configuration of the JAX package into its
twin here.

Compiled-in constants of the reference exposed here:
  * ``knn_normals`` = 45       (CommonFunc.h:41)
  * ``min_patch_points`` = 20  (CommonFunc.h:42)
  * SOR neighbours = 14, std-multiplier 2.7 (pairwise) / 5.0 (4D)
    (Registration.cpp:272-273, :415-416)
  * LoD z-score 1.96, max/min LoD ratio 2.0 (Registration.cpp:751-766)
  * DT geometric-decay clamp [0.5, 0.8]     (Registration.cpp:919-920)
  * patch planarity filters: variation <= 0.02, planarity >= 0.25
    (Segmentation.cpp:127)
  * supervoxel size default 10 x resolution (Registration.cpp:635-640)
  * auto DT-init = 3 x 75th-percentile C2C distance (Registration.cpp:627-630)
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Optional

ARC_TO_GON = 200.0 / math.pi  # 63.66197723675813; CommonFunc.h:40


class ConfigError(ValueError):
    """Raised when a configuration is invalid (reference: stderr + false)."""


@dataclasses.dataclass
class PiecewiseICPConfig:
    """All tunables of the Piecewise-ICP pipeline in one place."""

    # ---- the 11 reference text-config fields (CommonFunc.h:48-61) ----
    path1: str = ""              # target PC file, or 4D input folder
    path2: str = ""              # source PC file, or 4D output folder
    set_res_svsize: bool = True  # manual resolution / SV size?
    res1: float = 0.005          # avg point spacing of cloud 1 [m]
    res2: float = 0.005          # avg point spacing of cloud 2 [m]
    svsize1: float = 0.05        # supervoxel seed size, cloud 1 [m]
    svsize2: float = 0.05        # supervoxel seed size, cloud 2 [m]
    set_dtinit: bool = True      # manual initial distance threshold?
    dt_init: float = 0.05        # initial distance threshold [m]
    dt_min: float = 0.004        # minimum level of detection [m]
    visual: bool = False         # visualisation flag (export-only here)

    # ---- compiled-in constants of the reference, now configurable ----
    knn_normals: int = 45          # k-NN for PCA normals (CommonFunc.h:41)
    min_patch_points: int = 20     # min points per patch (CommonFunc.h:42)
    sor_neighbors: int = 14        # SOR k (Registration.cpp:272)
    sor_std_mult_pair: float = 2.7   # pairwise SOR sigma (Registration.cpp:272)
    sor_std_mult_4d: float = 5.0     # 4D SOR sigma (Registration.cpp:415)
    lod_z: float = 1.96            # 95% confidence (Registration.cpp:759)
    lod_max_ratio: float = 2.0     # maxLoD = ratio * DTmin (Registration.cpp:751)
    dt_decay_lo: float = 0.5       # stage-2 decay clamp (Registration.cpp:920)
    dt_decay_hi: float = 0.8       # stage-2 decay clamp (Registration.cpp:919)
    max_variation: float = 0.02    # patch curvature gate (Segmentation.cpp:127)
    min_planarity: float = 0.25    # patch planarity gate (Segmentation.cpp:127)
    sv_size_res_mult: float = 10.0   # SVres = 10*res default (Registration.cpp:635)
    dtinit_percentile: float = 0.75  # auto DT percentile (Registration.cpp:628)
    dtinit_mult: float = 3.0         # auto DT multiplier (Registration.cpp:629)
    patch_trim_sigma: float = 2.0    # 2-sigma plane trim (Segmentation.cpp:116)
    refine_passes: int = 1           # reference trims exactly once
    icp_max_iterations: int = 100    # inner P2P ICP (Registration.cpp:1264)
    icp_transformation_eps: float = 1e-8  # Registration.cpp:1262
    icp_fitness_eps: float = 1e-6         # Registration.cpp:877
    min_stable_patches: int = 4      # abort threshold (Registration.cpp:728,:864)
    # Inner-ICP residual variant: "reference" = target-normal point-to-plane
    # (PCL IterativeClosestPointWithNormals semantics); "symmetric" = the
    # symmetric point-to-plane objective (Rusinkiewicz 2019) using the
    # bisector of the matched target/source patch normals — cancels the
    # first-order curvature bias of centroid correspondences and typically
    # tightens transforms beyond the reference's accuracy.  Opt-in.
    icp_variant: str = "reference"
    # Inner-ICP row weighting: "uniform" = every stable correspondence
    # counts equally (reference semantics, Registration.cpp:1300-1319);
    # "inverse_variance" = Gauss-Markov weights 1/(sigmaCT1^2 + sigmaBP2^2)
    # from the per-patch plane-fit STDs the pipeline already carries —
    # noisy/large patches stop dominating the 6x6 normal equations.
    # Opt-in beyond-reference accuracy option.
    icp_weighting: str = "uniform"
    # Robust final refinement (beyond-reference: "two-sided
    # stability" / change-region exclusion): after convergence
    # the final stable-centroid solve is re-estimated with the Tukey
    # biweight M-estimator (IRLS, c = 4.685 sigma_MAD).  Sub-LoD changed
    # surface leaking through the DT/LoD classification biases the plain
    # least-squares fit — and because the fit absorbs the leak, post-fit
    # residual screening cannot find it (measured).  The redescending
    # M-estimator converges to the unchanged majority instead and
    # zero-weights the leaked patches; on change-free scenes it equals
    # least squares to within noise (95% efficiency).  "always" | "auto"
    # (only when the final stable ratio falls below guard_stable_ratio —
    # the suspect pairs where leak is plausible) | "off" (True/False
    # accepted as always/off).
    robust_refine: object = "auto"
    # Sign-coherence change screen: a first attempt at the same
    # problem (spatially-averaged standardized residual threshold).
    # Measured nearly uncorrelated with true change on the hard pairs
    # (the fit absorbs the leak) — kept as an opt-in diagnostic.
    change_screen: bool = False
    change_screen_k: int = 6         # stable-patch neighbourhood size
    change_screen_z: float = 2.5     # coherence threshold [sigma]
    # Acceptance guard (beyond-reference): pairs
    # whose final stable ratio falls below the threshold (= a large
    # changed/low-overlap area, where the result is sensitive to the
    # patch draw) are re-run with extra seed-lattice phase draws; the
    # accepted transform is the GLS (VCM-weighted) fusion of the three
    # lowest-sigma0 draws (sigma0 rank-correlates with true error on
    # such pairs, and the VCM weighting fuses correctly along the
    # narrow-band rot/trans tradeoff direction).
    guard_enabled: bool = True
    guard_stable_ratio: float = 0.35
    guard_draws: int = 9             # total draws on a flagged pair
    guard_escalate_z: float = 2.0    # probe-disagreement escalation [sigma]
    # Warm-start direct-to-reference pairs with the previous epoch's
    # composed estimate (beyond-reference): far-epoch direct pairs are
    # bistable under large misalignment for the reference too (its own
    # golden worst case is 764 mgon); starting the solve from the chain
    # guess keeps it in the right basin while still registering the raw
    # pair.  Disabled by --reference-semantics.
    warm_start_direct: bool = True

    # ---- 4D orchestration ----
    epoch_prefix: str = "Epoch_"   # timestamp prefix (CommonFunc.cpp:191)
    epoch_digits: int = 3          # timestamp length (CommonFunc.cpp:191)
    overlap_threshold: float = 0.75  # adaptive pair overlap (python/main.py:36)

    # ---- Kalman smoothing of the transform time series (paper feature;
    #      absent from the released reference code) ----
    kalman_enabled: bool = False
    # diag process noise [rad^2 / m^2]; "auto" matches it to the observed
    # epoch-to-epoch increments (see models/kalman.py)
    kalman_process_noise: object = "auto"

    # ---- segmentation ----
    # anchor the supervoxel seed lattice to the WORLD frame (multiples of
    # the supervoxel size): epochs then decompose into nearly identical
    # patch sets, immune to bounding-box jitter (outliers, scene-edge
    # deformation).  Default OFF: an A/B on the 20-epoch
    # synthetic campaign measured ALIGNED decompositions WORSE on chained
    # accuracy (mean rot [12.7, 8.9, 22.2] vs [10.8, 8.4, 16.0] mgon
    # unaligned) — correlated patch-sampling error accumulates through
    # the chain where independent per-epoch sampling partially averages
    # out.  Opt-in where cross-epoch patch correspondence itself matters
    # (e.g. per-patch deformation tracking).
    seed_grid_align: bool = False

    def validate(self) -> "PiecewiseICPConfig":
        """Range checks mirroring readConfigFile (CommonFunc.cpp:52-123)."""
        if self.res1 <= 0:
            raise ConfigError("PCres1 out of limits!")
        if self.res2 <= 0:
            raise ConfigError("PCres2 out of limits!")
        if self.set_res_svsize:
            if not (self.res1 <= self.svsize1 <= 40 * self.res1):
                raise ConfigError("SVsize1 out of limits!")
            if not (self.res2 <= self.svsize2 <= 40 * self.res2):
                raise ConfigError("SVsize2 out of limits!")
        if self.dt_init <= 0:
            raise ConfigError("DTinit out of limits!")
        if self.dt_init < self.dt_min:
            raise ConfigError("DTmin out of limits!")
        return self

    # ------------------------------------------------------------------
    @classmethod
    def from_reference_file(cls, path: str | pathlib.Path,
                            **overrides) -> "PiecewiseICPConfig":
        """Parse the reference's 11-line text config.

        Line format: ``<doc text>: <value>`` — value is everything after the
        first ':' (CommonFunc.cpp:24 uses ``find(":") + 2`` for the two path
        fields, i.e. skips ': ', and ``find(":") + 1`` for numeric fields).
        """
        lines = pathlib.Path(path).read_text().splitlines()
        # pad to 11 entries; empty lines keep defaults like the reference
        while len(lines) < 11:
            lines.append("")

        def val(line: str) -> Optional[str]:
            if not line or ":" not in line:
                return None
            return line[line.index(":") + 1:].strip()

        cfg = cls()
        fields = [
            ("path1", str), ("path2", str),
            ("set_res_svsize", lambda s: bool(int(float(s)))),
            ("res1", float), ("res2", float),
            ("svsize1", float), ("svsize2", float),
            ("set_dtinit", lambda s: bool(int(float(s)))),
            ("dt_init", float), ("dt_min", float),
            ("visual", lambda s: bool(int(float(s)))),
        ]
        for line, (name, conv) in zip(lines, fields):
            v = val(line)
            if v is not None and v != "":
                setattr(cfg, name, conv(v))
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ConfigError(f"unknown config override: {k}")
            setattr(cfg, k, v)
        return cfg.validate()

    def to_reference_file(self, path: str | pathlib.Path) -> None:
        """Write a reference-compatible text config."""
        txt = (
            f"string FolderFilePath1: {self.path1}\n"
            f"string FolderFilePath2: {self.path2}\n"
            f"bool isSetResSVsize (yes-1, no-0): {int(self.set_res_svsize)}\n"
            f"float PCres1 (m): {self.res1}\n"
            f"float PCres2 (m): {self.res2}\n"
            f"float SVsize1 (m): {self.svsize1}\n"
            f"float SVsize2 (m): {self.svsize2}\n"
            f"bool isSetDTinit (yes-1, no-0): {int(self.set_dtinit)}\n"
            f"float DTinit (m): {self.dt_init}\n"
            f"float DTmin (m): {self.dt_min}\n"
            f"bool isVisual (yes-1, no-0): {int(self.visual)}"
        )
        pathlib.Path(path).write_text(txt)


