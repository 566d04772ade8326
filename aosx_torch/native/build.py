"""``python -m aosx_torch.native.build``: compile the native host library
into ``aosx_torch/_build/``."""

from .binding import build

if __name__ == "__main__":
    print("native build:", build())
