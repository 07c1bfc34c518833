"""FLOPs of the model from the configuration's shapes: 2 * MACs of every
conv of one forward (conv records of the reference at the step's batch);
a train step counts three forwards (forward, and the backward's two
products)."""


def forward_flops(records) -> float:
    return float(sum(2.0 * b * h * w * cin * cout * k * k
                     for _, b, h, w, cin, cout, k, _, _ in records))


def train_flops(records) -> float:
    return 3.0 * forward_flops(records)
