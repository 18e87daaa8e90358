"""The benchmark of ``repro_torch``: Adaptive SGD on the paper's XML
datasets, driven through ``ElasticTrainer`` on one card or four.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root; README.md says how cells,
configurations and metrics are added as files.
"""
