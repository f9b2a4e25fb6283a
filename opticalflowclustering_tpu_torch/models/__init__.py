"""The learned models (port of opticalflowclustering_tpu.models): the bounce
classifier, the cv2.dnn classification slot and FlowCellNet."""
