"""tempest_tpu — a JAX TEMPEST signal-processing framework.

Brand-new JAX/XLA re-design with the capabilities of
JuliaTelecom/TempestSDR.jl (see SURVEY.md): raw IQ blocks stream into a fused,
jitted signal chain — AM envelope demodulation, FFT autocorrelation for
refresh-rate and line-count estimation, video-mode inference, resampling locked
to the inferred pixel clock, correlation-driven frame synchronisation, and
exponentially-averaged frame reconstruction — scaling from a single chip to
multi-host meshes by sharding time blocks and video-mode hypotheses.

For authorized security research into electromagnetic side-channel leakage.
"""

from .video.modes import (
    VideoMode,
    ALL_VIDEO_MODES,
    find_closest_mode,
    find_closest_configuration,
    find_configuration,
    get_refresh_rates,
    candidate_modes,
)
from .io.dat import (
    read_complex_binary,
    write_complex_binary,
    iter_complex_blocks,
    num_samples,
)
from .io.synthetic import (
    SyntheticCapture,
    generate_iq,
    generate_iq_harmonics,
    render_frame,
    test_pattern,
)
from .ops.demod import (am_demod, am_demod_power, invert_am_demod, fm_demod,
                        fm_demod_rows)
from .ops.spectrum import get_spectrum, get_welch, get_waterfall
from .ops.autocorr import (
    autocorrelation,
    zoom_autocorr,
    estimate_refresh,
    estimate_line_count,
    top_line_period_peaks,
)
from .ops.resample import (
    linear_resample,
    sig_to_image,
    downgrade_image,
    frame_to_screen,
    naive_upsample,
    upsample_fft,
    polyphase_resample,
    RENDER_SIZE,
)
from .ops.scan import ScanResult, carrier_score, channelize, scan_band, scan_centers
from .ops.enhance import interp_kernel_ft, restore_image, wiener_gain
from .ops.combine import CombineResult, combine_harmonics
from .ops.framesync import (
    frame_sync,
    frame_sync_subpixel,
    align_frame,
    align_frame_subpixel,
    blank_scores,
    contrast_scores,
    SyncSpec,
)
from .pipeline.offline import (
    TimingEstimate,
    TimingEvidence,
    ReconstructionConfig,
    Reconstruction,
    estimate_timing,
    timing_evidence,
    pick_line_peak,
    make_reconstruct_fn,
    make_batched_reconstruct_fn,
    reconstruct_frames,
    auto_reconstruct,
    combined_reconstruct,
    discover_screens,
    reconstruct_all_emissions,
)

__version__ = "0.1.0"
