"""Mean duration of the program's ``lm.decode_step`` span (one greedy
token for every request of the batch, to its copy to the host), ms."""
from nspubench import lm_readers


def read(ctx):
    return lm_readers.span_ms(ctx, "lm.decode_step")
