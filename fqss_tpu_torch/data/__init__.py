"""Host-side data: synthetic mixtures and music stems, LibriMix and MUSDB18-HQ loaders."""

from fqss_tpu_torch.data.synthetic import synth_batch, synth_music_batch, synth_sources

__all__ = ["synth_batch", "synth_music_batch", "synth_sources"]
