"""The counts chip_smoke.py's ``[shards]`` phase must show on the card
(PERF.md, PR 23's prediction): my CPU run of the phase at reduced width
with the full width's handoff bytes and cost model
(``chip_smoke.as_full_width``), per shard in shard order.  Admission,
placement, preemption, swaps, handoffs and the transfer's parking depend
only on the traffic's lengths and content and those sizes, so the card
reproduces them exactly (its first run of the phase did)."""
S2 = dict(finished=[11, 13], decoded=[725, 811], prefilled=[4416, 4209],
          preemptions=[0, 1], swap_losts=[0, 0], swap_outs=[1, 1],
          steps=[154, 155],
          defers=[{"no_blocks": 77}, {"no_blocks": 98, "no_slot": 2}],
          migrations=1, requeued_lost=0, handoffs=0, handoff_bytes=0,
          migrated={"rid": 0, "src": 0, "pos": 500, "dst": 1})
KILL = dict(finished=[24, 0], decoded=[1586, 59], prefilled=[6753, 2720],
            preemptions=[11, 0], swap_losts=[15, 0], swap_outs=[11, 0],
            steps=[281, 24],
            defers=[{"no_blocks": 202, "no_slot": 5}, {"no_blocks": 16}],
            migrations=0, requeued_lost=12, handoffs=0, handoff_bytes=0,
            rescued={"decode": 6, "queued": 6},
            swap_lost_events={"shard_lost": 12, "chain_evicted": 3})
# greedy traced, sampled and through the front-end alike
PD = dict(finished=[0, 12, 12], decoded=[24, 756, 756],
          prefilled=[9248, 0, 0], preemptions=[0, 2, 3],
          swap_losts=[0, 0, 0], swap_outs=[24, 2, 3], steps=[81, 468, 463],
          defers=[{"no_blocks": 62, "no_slot": 5},
                  {"transfer_pending": 2948, "no_blocks": 101},
                  {"transfer_pending": 2982, "no_blocks": 96}],
          migrations=0, requeued_lost=0, handoffs=24,
          handoff_bytes=993317600)
MAMBA2 = dict(finished=[0, 8], decoded=[8, 248], prefilled=[4993, 0],
              preemptions=[0, 0], swap_losts=[0, 0], swap_outs=[8, 0],
              steps=[43, 117],
              defers=[{"no_blocks": 16},
                      {"transfer_pending": 383, "no_blocks": 11}],
              migrations=0, requeued_lost=0, handoffs=8,
              handoff_bytes=137580068, slot_handoffs=8)
