"""Configuration of the PyTorch/CUDA nanopore aligner / SNP caller.

Twin of ``nadavca_tpu.config``: the same flat, frozen, YAML-loadable
dataclass with identical field names and defaults, so a YAML file written by
either package loads in the other. Fields that only shape the TPU kernels are
kept for that round trip and documented as ignored here.

``yaml`` is imported inside the two functions that need it, so the package
imports without it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Parameters of signal→reference alignment and SNP calling."""

    # --- k-mer / pore model ---
    k: int = 6                    # k-mer length of the pore model (R9.4-era default)
    # --- signal normalization ---
    normalization: str = "mad"    # "mad" (median/MAD) or "meanstd"
    # --- banded DP ---
    band_width: int = 128         # total band width B (slots); multiple of 128
    log_p_stay: float = -0.1054   # log prob of emitting another sample at same position (~0.9)
    log_p_move: float = -2.3026   # log prob of advancing one position (~0.1)
    log_p_skip: float = -1e30     # log prob of skipping a position (disabled by default)
    use_skip: bool = False        # enable the skip transition (advance by 2)
    # --- SNP calling ---
    snp_prior: float = 0.25       # uniform prior over the 4 bases
    snp_threshold: float = 0.9    # posterior threshold for emitting a call
    snp_rescore: str = "local"    # "local": restricted re-DP per substitution
                                  # (reference semantics);
                                  # "fixed": closed-form fixed-path re-score (approximation)
    snp_local_window: int = 192   # max samples per local re-DP window
    snp_ll_clip: float = 25.0     # per-read per-position |log-lik delta| cap
                                  # (bounds the influence of one bad read)
    snp_vote_margin: float = 3.0  # per-read margin for an alt "vote"
    snp_min_alt_votes: int = 3    # reads voting alt required for a call
    snp_cluster_prune: bool = True  # suppress weaker calls within k of a stronger one
    # --- joint adjacent-hypothesis rescore (opt-in; see joint.py) ---
    # candidate clusters are re-scored by full re-alignment of each read's
    # signal slice under every single-SNP hypothesis near the cluster; a call
    # moves only when the per-read median prefers the new hypothesis by
    # snp_joint_repos_margin with at least snp_joint_min_reads covering reads.
    # snp_joint_skip runs those slice alignments with the skip transition at
    # snp_joint_log_p_skip; snp_joint_filter_mad > 0 drops reads whose fit is
    # that many MADs below the cluster median.
    snp_joint_rescore: bool = False
    snp_joint_pad: int = 12
    snp_joint_min_reads: int = 4
    snp_joint_repos_margin: float = 25.0
    snp_joint_skip: bool = False
    snp_joint_log_p_skip: float = -3.5
    snp_joint_filter_mad: float = 0.0
    # "cpu" or "default", validated and kept so YAML files round-trip; the
    # port's joint pass runs on the device the api call names
    snp_joint_device: str = "cpu"
    # --- batching ---
    # signal-length buckets: ~1.25x geometric steps (128-aligned) bound the
    # worst-case padding waste at ~20%
    bucket_edges: tuple = (1024, 1280, 1664, 2176, 2816, 3584, 4480, 5632,
                           7040, 8832, 11136, 13952, 17536, 22016, 27520,
                           34432, 43136, 54016, 65536)
    signal_chunk: int = 128       # samples per band-offset update (multiple of 32)
    read_tile: int = 32           # batch rows round up to max(read_tile, 8), as in
                                  # the JAX package, so both pad alike; the CUDA
                                  # kernels themselves take any row count
    adaptive_band_threshold: int = 16384  # signal samples above which the wide band is used
    band_width_long: int = 256    # band width for long reads (adaptive band)
    kernel_unroll: object = True  # TPU fill-kernel loop unroll: kept so YAML
                                  # files round-trip, ignored by the port
    # two samples per serial step of the fill, without skip only: half the
    # barriers per sample for about twice the float operations. Scores match
    # the single-step fill to float32 rounding; near-tie decisions can differ.
    dp_pair_step: bool = False
    # --- kept so YAML files round-trip; ignored by the port ---
    data_axis: str = "data"       # JAX mesh axis name
    genome_axis: str = "genome"   # JAX mesh axis name

    def __post_init__(self):
        if self.band_width % 128 != 0:
            raise ValueError(f"band_width must be a multiple of 128, got {self.band_width}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.snp_joint_device not in ("cpu", "default"):
            raise ValueError('snp_joint_device must be "cpu" or "default", got '
                             f"{self.snp_joint_device!r}")

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "AlignConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        raw.update(overrides)
        if "bucket_edges" in raw:
            raw["bucket_edges"] = tuple(raw["bucket_edges"])
        return cls(**raw)

    def to_yaml(self, path: str) -> None:
        import yaml

        d = dataclasses.asdict(self)
        d["bucket_edges"] = list(d["bucket_edges"])
        with open(path, "w") as f:
            yaml.safe_dump(d, f)


DEFAULT_CONFIG = AlignConfig()
