"""The program's ``decode_steps`` counter (``ops/decode.py``): each decode
call adds the steps it ran, once, on the plain route here as on the
kernel's; a decode resumed through a ``DecodeCarry`` adds each chunk's
steps, so the chunks of one decode add up to its total."""

import pytest
import torch

from gst_tacotron_tpu_torch.config import AttentionConfig, DecoderConfig
from gst_tacotron_tpu_torch.models.decoder import Decoder
from gst_tacotron_tpu_torch.ops.decode import decode_carry, decode_scan
from gst_tacotron_tpu_torch.utils import profiling

torch.set_num_threads(2)

NUM_MELS, MEM_DIM = 8, 16
DEC = DecoderConfig(prenet_dims=(16, 8), attention_rnn_dim=16, decoder_rnn_dim=16,
                    num_decoder_rnn_layers=2, reduction_factor=2, max_decode_steps=6,
                    use_stop_token=True, stop_threshold=1.0)
KINDS = {"bahdanau": AttentionConfig(kind="bahdanau", dim=16),
         "location_sensitive": AttentionConfig(kind="location_sensitive", dim=16,
                                               location_filters=4, location_kernel_size=5)}


@pytest.fixture(params=sorted(KINDS))
def decode(request):
    """(the decoder, memory, lengths, and ``decode_scan``'s arguments but
    the steps and the carry)."""
    torch.manual_seed(0)
    dec = Decoder(DEC, KINDS[request.param], NUM_MELS, MEM_DIM).eval()
    memory = torch.randn(3, 9, MEM_DIM)
    lengths = torch.tensor([9, 6, 1])
    args = (dec.cell.pack(), memory, dec.cell.precompute_keys(memory), lengths)
    kw = dict(dec_cfg=dec.cfg, attn_cfg=dec.attn_cfg, num_mels=NUM_MELS, seed=7,
              use_dropout=True)
    return dec, memory, lengths, args, kw


def steps_counted():
    return profiling.counters().get("decode_steps", 0)


@torch.no_grad()
def test_each_decode_counts_its_steps_once(decode):
    dec, memory, lengths, args, kw = decode
    profiling.reset_counters()
    decode_scan(*args, steps=6, **kw)
    assert steps_counted() == 6
    decode_scan(*args, steps=4, **kw)
    assert steps_counted() == 10
    # the model's own decode, at its step budget
    dec.decode(memory, lengths, seed=7)
    assert steps_counted() == 10 + DEC.max_decode_steps
    # nothing decoded, nothing counted
    decode_scan(*args, steps=0, **kw)
    assert steps_counted() == 10 + DEC.max_decode_steps


@torch.no_grad()
def test_resumed_chunks_add_up_to_the_total(decode):
    dec, memory, _, args, kw = decode
    profiling.reset_counters()
    carry = decode_carry(memory, dec_cfg=dec.cfg, num_mels=NUM_MELS, total_steps=14)
    done = 0
    for steps in (3, 1, 6, 4):
        decode_scan(*args, steps=steps, carry=carry, **kw)
        done += steps
        assert steps_counted() == done
    assert carry.step == steps_counted() == 14
