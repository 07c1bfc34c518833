#!/bin/bash
# The PyTorch port's data-parallel training on 4 cards against 1, on a host
# with 4 GPUs: train_det --use_ddp under torchrun at the shipped config on
# chip_smoke.py's synthetic 640x640 JPEGs (256 train, 16 valid; global batch
# 64, 3 epochs; 1, 4, 1, 4 cards in turns), then train_tracknet --use_ddp on
# 4 cards. Prints each run's seconds and its train_metrics.csv losses and
# images/s; the logs and CSVs go to chiprun_out/.
#
#   bash dev/torch_ddp_scaling.sh
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
OUT="$REPO/chiprun_out"
mkdir -p "$OUT"
D=$(mktemp -d)
cd "$REPO" && python3 -c "import chip_smoke as c, sys; c.write_train_data(sys.argv[1], 256)" "$D"
python3 -c "import chip_smoke as c, sys; c.write_tn_train_data(sys.argv[1])" "$D/tn"
cp "$D/anchors.yaml" "$D/anchors.orig"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for n in 1 4 1 4; do
  cd "$D"; rm -rf metrics saved_model; cp anchors.orig anchors.yaml
  s=$(date +%s.%N)
  PYTHONPATH="$REPO" python3 -m torch.distributed.run --standalone --nproc_per_node $n \
    -m vision_conglomerate_torch.train_det --use_ddp --config_path config.yaml \
    --anchors_path anchors.yaml --batch_size 64 --epochs 3 --checkpoint_interval 3 \
    --no_verbose --device cuda > "$OUT/ddp4_det_n$n.log" 2>&1
  e=$(date +%s.%N)
  echo "det n=$n seconds=$(python3 -c "print(round($e - $s, 2))")"
  cat metrics/detection/train_metrics.csv | cut -d, -f1,11
  cp metrics/detection/train_metrics.csv "$OUT/ddp4_det_train_n$n.csv"
  cp metrics/detection/eval_metrics.csv "$OUT/ddp4_det_eval_n$n.csv"
done
cd "$D/tn"
s=$(date +%s.%N)
PYTHONPATH="$REPO" python3 -m torch.distributed.run --standalone --nproc_per_node 4 \
  -m vision_conglomerate_torch.train_tracknet --use_ddp --config_path config.yaml \
  --batch_size 16 --epochs 2 --checkpoint_interval 2 --no_verbose --device cuda \
  > "$OUT/ddp4_tn.log" 2>&1
e=$(date +%s.%N)
echo "tracknet n=4 seconds=$(python3 -c "print(round($e - $s, 2))")"
cat metrics/tracknet/train_metrics.csv metrics/tracknet/eval_metrics.csv
