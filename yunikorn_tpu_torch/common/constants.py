"""Shared constants: labels, annotations, scheduler identity, gang parameters.

Role-equivalent to the reference's pkg/common/constants/constants.go. The domain
prefixes are kept wire-compatible so workloads labeled for the reference scheduler
work unchanged against this framework.
"""

TRUE = "true"
FALSE = "false"

DOMAIN = "yunikorn.apache.org/"
DOMAIN_INTERNAL = "yunikorn.apache.org/internal-"

# Cluster / node attributes
NODE_ATTRIBUTE_HOSTNAME = "si.io/hostname"
NODE_ATTRIBUTE_RACKNAME = "si.io/rackname"
NODE_INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
DEFAULT_RACK = "/rack-default"

# Application identification (resolution order mirrors utils.GetApplicationIDFromPod,
# reference pkg/common/utils/utils.go:141-188)
LABEL_APP = "app"
LABEL_APPLICATION_ID = "applicationId"
CANONICAL_LABEL_APP_ID = DOMAIN + "app-id"
ANNOTATION_APP_ID = DOMAIN + "app-id"
LABEL_QUEUE_NAME = "queue"
CANONICAL_LABEL_QUEUE_NAME = DOMAIN + "queue"
ANNOTATION_QUEUE_NAME = DOMAIN + "queue"
ANNOTATION_PARENT_QUEUE = DOMAIN + "parentqueue"
# multi-partition routing (extension beyond the single-partition reference
# shim): node label → SI node attribute → core partition router
LABEL_NODE_PARTITION = DOMAIN + "node-partition"
ANNOTATION_PARTITION = DOMAIN + "partition"
SI_NODE_PARTITION = "si/node-partition"
LABEL_SPARK_APP_ID = "spark-app-selector"

ROOT_QUEUE = "root"
DEFAULT_PARTITION = "default"
APP_TAG_NAMESPACE = "namespace"
APP_TAG_NAMESPACE_PARENT_QUEUE = "namespace.parentqueue"
APP_TAG_IMAGE_PULL_SECRETS = "imagePullSecrets"
DEFAULT_APP_NAMESPACE = "default"
DEFAULT_USER_LABEL = DOMAIN + "username"
DEFAULT_USER = "nobody"

# Scheduler identity / config
SCHEDULER_NAME = "yunikorn"
CONFIGMAP_NAME = "yunikorn-configs"
DEFAULT_CONFIGMAP_NAME = "yunikorn-defaults"

# Gang scheduling
PLACEHOLDER_CONTAINER_IMAGE = "registry.k8s.io/pause:3.7"
PLACEHOLDER_CONTAINER_NAME = "pause"
PLACEHOLDER_POD_RESTART_POLICY = "Never"
ANNOTATION_PLACEHOLDER_FLAG = DOMAIN_INTERNAL + "placeholder"
ANNOTATION_TASK_GROUP_NAME = DOMAIN + "task-group-name"
ANNOTATION_TASK_GROUPS = DOMAIN + "task-groups"
ANNOTATION_SCHED_POLICY_PARAM = DOMAIN + "schedulingPolicyParameters"
SCHED_POLICY_TIMEOUT_PARAM = "placeholderTimeoutInSeconds"
SCHED_POLICY_PARAM_DELIMITER = " "
SCHED_POLICY_STYLE_PARAM = "gangSchedulingStyle"
GANG_STYLE_SOFT = "Soft"
GANG_STYLE_HARD = "Hard"
GANG_STYLES = (GANG_STYLE_SOFT, GANG_STYLE_HARD)

APP_FAIL_RESERVATION_TIMEOUT = "ResourceReservationTimeout"
APP_FAIL_REJECTED = "ApplicationRejected"

# Namespace quota annotations
NAMESPACE_QUOTA = DOMAIN + "namespace.quota"
NAMESPACE_GUARANTEED = DOMAIN + "namespace.guaranteed"
NAMESPACE_MAX_APPS = DOMAIN + "namespace.maxApps"
CPU_QUOTA_LEGACY = DOMAIN + "namespace.max.cpu"
MEM_QUOTA_LEGACY = DOMAIN + "namespace.max.memory"

# PriorityClass / preemption
ANNOTATION_ALLOW_PREEMPTION = DOMAIN + "allow-preemption"

# Admission
ANNOTATION_GENERATE_APP_ID = DOMAIN + "namespace.generateAppId"
ANNOTATION_ENABLE_YUNIKORN = DOMAIN + "namespace.enableYuniKorn"
ANNOTATION_USER_INFO = DOMAIN + "user.info"
ANNOTATION_IGNORE_APPLICATION = DOMAIN_INTERNAL + "ignore-application"

# OwnerReferences
DAEMONSET_KIND = "DaemonSet"
NODE_KIND = "Node"

# Taints
TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"
