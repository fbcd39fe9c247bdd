"""Verilog RTL generation for TNN columns (paper §II-B).

The real TNNGen uses Veriloggen/PyVerilog to emit RTL matching the
microarchitecture of Nair et al. (ISVLSI'21): per-synapse ramp-no-leak
response units (down-counters), per-neuron accumulate + threshold
comparators, a first-spike WTA priority encoder, and per-synapse STDP units
with LFSR-gated probabilistic weight updates.  This module generates the
same structure as synthesizable Verilog-2001 text; a ``netlist_stats``
estimator reports flop/gate counts that ``flow.py`` feeds to the PDK models.

No EDA tool is shipped with the repository, so correctness is enforced by
structural tests (port/instance counts, balanced begin/end, golden snippets)
and by the cycle-accurate simulator, which implements identical semantics.

This is the port's own copy of the JAX package's ``hwgen/rtl.py`` (numpy
and the standard library only; the port imports nothing of the JAX
package).  The generated text is the JAX package's byte for byte except
the banner, which names the generator that wrote the file
(``repro_torch.hwgen``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """Hardware design point for one TNN column."""

    name: str
    p: int  # synapses per neuron
    q: int  # neurons
    theta: int  # firing threshold
    w_bits: int = 3
    t_max: int = 256

    @property
    def t_bits(self) -> int:
        return max(1, math.ceil(math.log2(self.t_max)))

    @property
    def w_max(self) -> int:
        return (1 << self.w_bits) - 1

    @property
    def synapse_count(self) -> int:
        return self.p * self.q

    @property
    def pot_bits(self) -> int:
        # body potential can reach p * w_max
        return max(1, math.ceil(math.log2(self.p * self.w_max + 1)))


def generate_rnl_unit(spec: ColumnSpec) -> str:
    """Per-synapse ramp-no-leak response unit.

    On the input spike the unit loads its weight into a down-counter; while
    the counter is nonzero it asserts ``ramping`` (the +1/cycle unary ramp
    contribution) and decrements.  This is the TNN7 custom macro's behaviour.
    """
    return f"""\
// auto-generated by repro_torch.hwgen (TNNGen reproduction) — do not edit
module rnl_unit #(
    parameter W_BITS = {spec.w_bits}
) (
    input  wire              clk,
    input  wire              rst,
    input  wire              in_spike,
    input  wire [W_BITS-1:0] weight,
    output wire              ramping
);
    reg [W_BITS-1:0] cnt;
    always @(posedge clk) begin
        if (rst)
            cnt <= {{W_BITS{{1'b0}}}};
        else if (in_spike)
            cnt <= weight;
        else if (cnt != {{W_BITS{{1'b0}}}})
            cnt <= cnt - 1'b1;
    end
    assign ramping = (cnt != {{W_BITS{{1'b0}}}});
endmodule
"""


def generate_neuron(spec: ColumnSpec) -> str:
    """Neuron body: adder tree over P ramp bits into the potential
    accumulator, plus the threshold comparator with a one-shot fire latch."""
    p, pot_bits = spec.p, spec.pot_bits
    sum_bits = max(1, math.ceil(math.log2(p + 1)))
    return f"""\
// auto-generated by repro_torch.hwgen (TNNGen reproduction) — do not edit
module neuron #(
    parameter P        = {p},
    parameter POT_BITS = {pot_bits},
    parameter THETA    = {spec.theta}
) (
    input  wire         clk,
    input  wire         rst,
    input  wire [P-1:0] ramping,
    output reg          fired,
    output wire         fire_now
);
    // popcount adder tree over the per-synapse ramp bits
    integer i;
    reg [{sum_bits}-1:0] act;
    always @(*) begin
        act = {{{sum_bits}{{1'b0}}}};
        for (i = 0; i < P; i = i + 1)
            act = act + ramping[i];
    end

    reg [POT_BITS-1:0] pot;
    always @(posedge clk) begin
        if (rst) begin
            pot   <= {{POT_BITS{{1'b0}}}};
            fired <= 1'b0;
        end else begin
            pot <= pot + act;
            if (!fired && (pot + act >= THETA))
                fired <= 1'b1;
        end
    end
    assign fire_now = !fired && (pot + act >= THETA);
endmodule
"""


def generate_wta(spec: ColumnSpec) -> str:
    """First-spike k=1 WTA: a latch records the first cycle any neuron
    fires; ties resolve by index priority (priority encoder)."""
    q = spec.q
    return f"""\
// auto-generated by repro_torch.hwgen (TNNGen reproduction) — do not edit
module wta_inhibit #(
    parameter Q = {q}
) (
    input  wire         clk,
    input  wire         rst,
    input  wire [Q-1:0] fire_now,
    output reg  [Q-1:0] win
);
    reg done;
    integer j;
    always @(posedge clk) begin
        if (rst) begin
            win  <= {{Q{{1'b0}}}};
            done <= 1'b0;
        end else if (!done && (|fire_now)) begin
            done <= 1'b1;
            // index-priority encoder over simultaneous firings
            begin : enc
                for (j = Q - 1; j >= 0; j = j - 1)
                    if (fire_now[j]) win <= ({{{{Q-1{{1'b0}}}}, 1'b1}} << j);
            end
        end
    end
endmodule
"""


def generate_stdp_unit(spec: ColumnSpec) -> str:
    """Per-synapse STDP update unit.

    Flags record whether the input (x) and the post-WTA output (y) spiked
    this gamma cycle and their order; at end-of-gamma the weight counter
    increments/decrements by one LSB, gated by an LFSR bit stream that
    realizes the update probabilities (mu_capture / mu_backoff / mu_search).
    """
    return f"""\
// auto-generated by repro_torch.hwgen (TNNGen reproduction) — do not edit
module stdp_unit #(
    parameter W_BITS = {spec.w_bits}
) (
    input  wire              clk,
    input  wire              rst,
    input  wire              gamma_end,
    input  wire              x_spiked,
    input  wire              y_spiked,
    input  wire              x_before_y,   // x_time <= y_time this gamma
    input  wire              lfsr_capture, // Bernoulli(mu_capture)
    input  wire              lfsr_backoff, // Bernoulli(mu_backoff)
    input  wire              lfsr_search,  // Bernoulli(mu_search)
    output reg  [W_BITS-1:0] weight
);
    localparam WMAX = {{W_BITS{{1'b1}}}};
    wire cap = x_spiked & y_spiked & x_before_y & lfsr_capture;
    wire bck = ((x_spiked & y_spiked & ~x_before_y) | (~x_spiked & y_spiked))
               & lfsr_backoff;
    wire sch = x_spiked & ~y_spiked & lfsr_search;
    always @(posedge clk) begin
        if (rst)
            weight <= {{1'b1, {{(W_BITS-1){{1'b0}}}}}}; // mid-rail reset
        else if (gamma_end) begin
            if ((cap | sch) && weight != WMAX)
                weight <= weight + 1'b1;
            else if (bck && weight != {{W_BITS{{1'b0}}}})
                weight <= weight - 1'b1;
        end
    end
endmodule
"""


def generate_column_top(spec: ColumnSpec) -> str:
    """Top level: P x Q synapse fabric (rnl + stdp per synapse), Q neurons,
    WTA, gamma counter, and an LFSR for the stochastic updates."""
    p, q = spec.p, spec.q
    return f"""\
// auto-generated by repro_torch.hwgen (TNNGen reproduction) — do not edit
// TNN column "{spec.name}": P={p} synapses/neuron, Q={q} neurons,
// {spec.synapse_count} synapses total, theta={spec.theta}, gamma={spec.t_max}.
module tnn_column_{spec.name} #(
    parameter P      = {p},
    parameter Q      = {q},
    parameter W_BITS = {spec.w_bits},
    parameter T_BITS = {spec.t_bits}
) (
    input  wire         clk,
    input  wire         rst,
    input  wire         learn_en,
    input  wire [P-1:0] in_spikes,
    output wire [Q-1:0] out_spikes
);
    // gamma (computational wave) counter
    reg [T_BITS-1:0] gamma_cnt;
    wire gamma_end = (gamma_cnt == {{T_BITS{{1'b1}}}});
    always @(posedge clk) begin
        if (rst) gamma_cnt <= {{T_BITS{{1'b0}}}};
        else     gamma_cnt <= gamma_cnt + 1'b1;
    end

    // 16-bit Fibonacci LFSR for stochastic STDP gating
    reg [15:0] lfsr;
    always @(posedge clk) begin
        if (rst) lfsr <= 16'hACE1;
        else     lfsr <= {{lfsr[14:0], lfsr[15] ^ lfsr[13] ^ lfsr[12] ^ lfsr[10]}};
    end

    wire [P*Q-1:0] ramping;
    wire [P*Q-1:0] w_flat; // exposed for scan/debug
    wire [Q-1:0]   fire_now;
    wire [Q-1:0]   fired;
    wire [Q-1:0]   win;

    genvar gi, gj;
    generate
        for (gj = 0; gj < Q; gj = gj + 1) begin : g_neuron
            for (gi = 0; gi < P; gi = gi + 1) begin : g_syn
                wire [W_BITS-1:0] w_ij;
                stdp_unit #(.W_BITS(W_BITS)) u_stdp (
                    .clk(clk), .rst(rst),
                    .gamma_end(gamma_end & learn_en),
                    .x_spiked(in_spikes[gi]),
                    .y_spiked(win[gj]),
                    .x_before_y(~fired[gj]),
                    .lfsr_capture(lfsr[0]),
                    .lfsr_backoff(lfsr[1]),
                    .lfsr_search(lfsr[2] & lfsr[3] & lfsr[4]),
                    .weight(w_ij)
                );
                rnl_unit #(.W_BITS(W_BITS)) u_rnl (
                    .clk(clk), .rst(rst),
                    .in_spike(in_spikes[gi]),
                    .weight(w_ij),
                    .ramping(ramping[gj*P + gi])
                );
                assign w_flat[gj*P + gi] = |w_ij;
            end
            neuron #(.P(P), .POT_BITS({spec.pot_bits}), .THETA({spec.theta}))
            u_neuron (
                .clk(clk), .rst(rst),
                .ramping(ramping[gj*P +: P]),
                .fired(fired[gj]),
                .fire_now(fire_now[gj])
            );
        end
    endgenerate

    wta_inhibit #(.Q(Q)) u_wta (
        .clk(clk), .rst(rst), .fire_now(fire_now), .win(win)
    );
    assign out_spikes = win;
endmodule
"""


def generate_testbench(spec: ColumnSpec) -> str:
    """Xcelium RTL-simulation testbench skeleton (paper Table I, stage 1)."""
    return f"""\
// auto-generated testbench for tnn_column_{spec.name}
`timescale 1ns/1ps
module tb_{spec.name};
    reg clk = 0, rst = 1, learn_en = 0;
    reg  [{spec.p - 1}:0] in_spikes = 0;
    wire [{spec.q - 1}:0] out_spikes;
    tnn_column_{spec.name} dut (
        .clk(clk), .rst(rst), .learn_en(learn_en),
        .in_spikes(in_spikes), .out_spikes(out_spikes)
    );
    always #0.5 clk = ~clk;
    initial begin
        $dumpfile("tnn_column_{spec.name}.vcd");
        $dumpvars(0, tb_{spec.name});
        repeat (4) @(posedge clk);
        rst = 0;
        // stimulus is loaded from volleys.memh by the flow scripts
        repeat ({spec.t_max * 4}) @(posedge clk);
        $finish;
    end
endmodule
"""


def generate_column(spec: ColumnSpec) -> dict:
    """All RTL files for one design: {filename: verilog_text}."""
    return {
        "rnl_unit.v": generate_rnl_unit(spec),
        "neuron.v": generate_neuron(spec),
        "wta_inhibit.v": generate_wta(spec),
        "stdp_unit.v": generate_stdp_unit(spec),
        f"tnn_column_{spec.name}.v": generate_column_top(spec),
        f"tb_{spec.name}.v": generate_testbench(spec),
    }


def netlist_stats(spec: ColumnSpec) -> dict:
    """Structural complexity estimate fed to the flow's silicon models.

    Flop counts follow directly from the architecture; gate-equivalents use
    standard adder/comparator costs.  The dominant term is per-synapse
    (w_bits counter + w_bits STDP weight + control), which is why the
    paper's area/leakage are linear in synapse count.
    """
    s = spec.synapse_count
    per_syn_flops = 2 * spec.w_bits  # rnl counter + stdp weight
    per_neuron_flops = spec.pot_bits + 2  # potential + fired + fire latch
    misc_flops = spec.t_bits + 16 + spec.q + 1  # gamma + lfsr + wta
    flops = s * per_syn_flops + spec.q * per_neuron_flops + misc_flops
    gates = (
        s * (6 * spec.w_bits + 4)  # counters, decrementers, stdp muxes
        + spec.q * (8 * spec.pot_bits + 3 * spec.p)  # adder tree + compare
        + 12 * spec.q  # wta
    )
    return {"synapses": s, "flops": flops, "gate_equivalents": gates}
