"""The NTSC modulator, demodulator and frame pipeline."""
