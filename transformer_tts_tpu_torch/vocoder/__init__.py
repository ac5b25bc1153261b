"""Neural vocoder, mel -> waveform (the port of
transformer_tts_tpu/vocoder/): the HiFi-GAN and iSTFT generators, the
MPD + MSD discriminator and their GAN train step."""
