"""Mean duration of the program's ``lm.prefill`` span (a batch's prefill,
a row at a time, to its first token's copy to the host), ms."""
from nspubench import lm_readers


def read(ctx):
    return lm_readers.span_ms(ctx, "lm.prefill")
