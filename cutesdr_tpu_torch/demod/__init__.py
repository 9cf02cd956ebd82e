"""Demodulators of the port: AM, SAM, FM and SSB/CW, mono and stereo.

The mode registry is the JAX package's (``cutesdr_tpu/demod/__init__.py``,
the reference's mode set, dsp/demodulator.h:20-28), declared here with the
same values; a test holds them equal."""

DEMOD_AM = 0
DEMOD_SAM = 1
DEMOD_FM = 2
DEMOD_USB = 3
DEMOD_LSB = 4
DEMOD_CWU = 5
DEMOD_CWL = 6

MODE_NAMES = {
    DEMOD_AM: "am", DEMOD_SAM: "sam", DEMOD_FM: "fm", DEMOD_USB: "usb",
    DEMOD_LSB: "lsb", DEMOD_CWU: "cwu", DEMOD_CWL: "cwl",
}
MODE_IDS = {v: k for k, v in MODE_NAMES.items()}
