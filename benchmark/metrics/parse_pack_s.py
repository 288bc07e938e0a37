"""parse_pack_s: the seconds the program's parser and packer
(io/packed.py, the native io/native/fastx.cpp) took over the cell's
samples in set-up."""


def read(ctx):
    return ctx.parse_pack_s
