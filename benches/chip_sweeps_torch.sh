#!/bin/sh
# The round-5 chip sweeps on the port (benches/chip_sweeps_r5.sh, with
# `python bench.py` as `python -m madsim_tpu_torch bench` and every
# `python -m madsim_tpu` as `python -m madsim_tpu_torch`), on the card.
# Every command prints one JSON line or a hunt summary; each runs on the
# card and exits 2 without one (append --device cpu to a line to run it
# on the CPU, slowly). Several shapes here are run nowhere else on the
# card (gossip at 33 nodes and Q = 320, s3 at 100k seeds). The hunt's
# corpus is chip_corpus_torch.json in the working directory, apart from
# the JAX sweeps' corpus.
#
# Serialize everything (one host feeds the card); total ~15-25 min.
set -x

# 1. Flagship bench (one JSON line; the port's history row)
python -m madsim_tpu_torch bench

# 2. Hunt end-to-end at high find rate: the hunt's seeds/s against the
#    clean multipaxos rate of step 3 (the reference's bar: within a few
#    percent of it)
time python -m madsim_tpu_torch hunt --machine demo-nopromise-multipaxos \
  --seeds 106000 --stream --batch 8192 --horizon 8 --queue 96 --faults 3 \
  --fault-kinds pair,kill,dir,group,storm --fault-tmax 3000000 \
  --max-steps 6000 --corpus chip_corpus_torch.json --limit 3

# 3. Clean-rate guard for the same machine (directive 3: "clean-run
#    number unharmed")
python -m madsim_tpu_torch bench --machine multipaxos --lanes 8192 --seeds 106000 \
  --reps 3 --horizon 8 --queue 96 --faults 3 \
  --fault-kinds pair,kill,dir,group,storm --fault-tmax 3000000 --max-steps 6000

# 4. Gossip 33-node at 100k seeds, full vocabulary incl. delay
#    (directive 6: the larger-n PROFILE row)
python -m madsim_tpu_torch bench --machine gossip --nodes 33 --lanes 8192 \
  --seeds 100000 --reps 1 --horizon 5 --queue 320 --faults 3 \
  --fault-kinds pair,kill,dir,group,storm,delay --fault-tmax 3000000 \
  --max-steps 9000

# 5. S3 machine at 100k seeds (directive 4's chip row)
python -m madsim_tpu_torch bench --machine s3 --nodes 4 --lanes 8192 \
  --seeds 100000 --reps 1 --horizon 8 --queue 48 --faults 3 \
  --fault-kinds pair,kill,dir,group,storm,delay --fault-tmax 3000000 \
  --max-steps 4000

# 6. Delay-exclusive bug class at scale (directive 5's find-rate row)
python -m madsim_tpu_torch explore --machine demo-giveup-mvcc --seeds 100000 \
  --stream --batch 8192 --horizon 8 --queue 48 --faults 3 \
  --fault-kinds delay --fault-tmax 3000000 --max-steps 3000
