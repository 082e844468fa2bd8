"""``python -m flacx_torch encode in.wav out.flac`` (see :mod:`cli`)."""

from flacx_torch.cli import main

if __name__ == "__main__":
    main()
